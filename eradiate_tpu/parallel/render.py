"""Sharded product-path renderers — one per tracer family.

The reference has **no distributed backend** (its spectral/sensor loops are
serial Python around the C++ kernel, ``src/eradiate/kernel/_render.py:433-468``);
this build creates the distributed layer. Every tracer family's
``render_batch_*_impl`` is wrapped in ``jax.shard_map`` over a 2D device mesh

    ("spectral", "sample")

- **spectral axis**: shards the per-(bin, g) medium tables, spectral row
  keys and accumulators. Embarrassingly parallel — no collectives beyond
  the output sharding.
- **sample axis**: replicates the scene and splits the per-pixel sample
  budget by *global sample-id slicing*: rank ``r`` traces sample ids
  ``[r * spp_local, (r + 1) * spp_local)`` of every pixel
  (``ops.tracer.lane_partition`` ``sample_offset``/``spp_stride`` hooks).
  Because threefry keys depend only on (pixel, global sample id), the
  union over ranks is exactly the single-device sample set — sharded
  estimates equal unsharded ones up to float summation order. The
  accumulators reduce with ONE ``pmean`` per dispatch, placed *after* the
  on-device chunk scan, so collective cost is O(1) per render instead of
  O(n_chunks) — the degenerate-optimal form of collective/compute overlap.

Each public function mirrors its single-device twin's chunking structure
(chunk boundaries and per-chunk key folds are computed from the *global*
budget), which is what makes the sharded product path testably equivalent
to the single-device one (``tests/unit/test_parallel_product.py``).

Multi-host: when ``jax.process_count() > 1`` (after
:func:`eradiate_tpu.parallel.multihost.initialize`), inputs are placed as
global arrays via ``jax.device_put`` with the mesh sharding (every process
holds the same host-side scene, each places only its addressable shards)
and outputs are gathered back to every host with ``process_allgather``.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.scene_state import IlluminationArrays
from ..ops.tracer import render_batch_impl

__all__ = [
    "make_render_mesh",
    "render_sharded",
    "render_polarized_sharded",
    "render_spherical_sharded",
    "render_spherical_polarized_sharded",
    "render_canopy_sharded",
    "render_canopy_polarized_sharded",
    "render_dem_sharded",
]


def make_render_mesh(n_spectral: int = 1, n_sample: int | None = None, devices=None):
    """Create a ("spectral", "sample") mesh over available devices.

    On a multi-host platform ``jax.devices()`` is the *global* device list;
    ``jax.experimental.mesh_utils`` lays the axes out so the inner (sample)
    axis stays within hosts (NVLink between a host's GPUs) and the spectral
    axis spans hosts — the spectral axis needs no collectives, so network
    hops between hosts are free.
    """
    devices = devices if devices is not None else jax.devices()
    n_dev = len(devices)
    if n_sample is None:
        n_sample = n_dev // n_spectral
    if n_spectral * n_sample != n_dev:
        raise ValueError(
            f"mesh {n_spectral}x{n_sample} does not cover {n_dev} devices"
        )
    if jax.process_count() > 1 and devices == jax.devices():
        from jax.experimental import mesh_utils

        dev_array = mesh_utils.create_device_mesh((n_spectral, n_sample))
    else:
        dev_array = np.asarray(devices).reshape(n_spectral, n_sample)
    return Mesh(dev_array, ("spectral", "sample"))


# ---------------------------------------------------------------------------
# PartitionSpec builders (structure-driven; geometry tables stay replicated)


def _spectral_specs(tree):
    """Every array leaf shards its leading (spectral) axis."""
    return jax.tree_util.tree_map(lambda _: P("spectral"), tree)


def _replicated_specs(tree):
    return jax.tree_util.tree_map(lambda _: P(), tree)


def _medium_specs(medium):
    """Specs for MediumArrays / SphericalMediumArrays: spectral tables shard,
    the geometry grid (``z_levels``/``radii``) replicates."""
    vals = {}
    for f in dataclasses.fields(type(medium)):
        v = getattr(medium, f.name)
        if f.name in ("z_levels", "radii", "mu_grid", "sun_r_grid",
                      "sun_mu_warp"):
            vals[f.name] = (
                jax.tree_util.tree_map(lambda _: P(), v)
                if isinstance(v, tuple)
                else P()
            )
        else:
            vals[f.name] = _spectral_specs(v)
    return type(medium)(**vals)


def _illum_specs(illum):
    return IlluminationArrays(
        direction=P(),
        irradiance=P("spectral"),
        cos_cutoff=P(),
        sky_radiance=(
            P("spectral") if getattr(illum.sky_radiance, "ndim", 0) else P()
        ),
        position=None if illum.position is None else P(),
    )


def _surface_specs(surface):
    return type(surface)(params=_spectral_specs(surface.params))


def _row_keys(seed, S):
    base_key = jax.random.key(seed)
    return jax.vmap(jax.random.fold_in)(
        jnp.broadcast_to(base_key, (S,)), jnp.arange(S)
    )


def _validate(mesh, S):
    n_spectral = mesh.shape["spectral"]
    n_sample = mesh.shape["sample"]
    if S % n_spectral != 0:
        raise ValueError(
            f"spectral batch {S} not divisible by mesh axis {n_spectral}"
        )
    return n_spectral, n_sample


def _put_global(mesh, args, specs):
    """Multi-host input placement: every process passes the same host-side
    arrays; device_put with the mesh sharding places each process's
    addressable shards, yielding global jax.Arrays. Typed PRNG-key arrays
    round-trip through key_data (they reject np.asarray)."""
    if jax.process_count() <= 1:
        return args

    def _global(arr, s):
        sharding = NamedSharding(mesh, s)
        return jax.make_array_from_callback(
            arr.shape, sharding, lambda idx: arr[idx]
        )

    def put(x, s):
        if x is None or s is None:
            return x
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jax.dtypes.prng_key):
            impl = jax.random.key_impl(x)
            g = _global(np.asarray(jax.random.key_data(x)), s)
            return jax.random.wrap_key_data(g, impl=impl)
        return _global(np.asarray(x), s)

    return jax.tree_util.tree_map(
        put, args, specs, is_leaf=lambda x: x is None
    )


def _fetch(out):
    """Bring a (possibly multi-host) output to host numpy on every process.

    Only device arrays gather; host scalars (e.g. the int ``spp``) pass
    through — ``process_allgather`` STACKS scalars into a per-process
    array, which would corrupt sample counts downstream."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        return jax.tree_util.tree_map(
            lambda x: (
                np.asarray(multihost_utils.process_allgather(x, tiled=True))
                if isinstance(x, jax.Array)
                else x
            ),
            out,
        )
    return out


# ---------------------------------------------------------------------------
# plane-parallel scalar


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 4))
def _pp_sharded(
    mesh, config, n_pix, spp_local, n_chunks,
    medium, surface, illum, directions, row_keys, target, ray_offset,
    target_extent,
):
    """Whole-measure sharded render in one device program (mirror of
    ``ops.tracer._render_full``): on-device chunk scan, single ``pmean``
    after the scan."""
    spp_stride = spp_local * mesh.shape["sample"]
    dtype = medium.tau_levels.dtype
    in_specs = (
        _medium_specs(medium),
        _surface_specs(surface),
        _illum_specs(illum),
        P(),
        P("spectral"),
        _replicated_specs((target, ray_offset, target_extent)),
    )

    def shard_fn(med, surf, ill, dirs, keys, sensor_args):
        tgt, roff, ext = sensor_args
        rank = jax.lax.axis_index("sample")
        S_local = keys.shape[0]

        def chunk_body(carry, chunk_id):
            rad_sum, m2_sum = carry
            ck = jax.vmap(jax.random.fold_in)(
                keys, jnp.full(S_local, chunk_id)
            )
            rad, m2 = render_batch_impl(
                config, n_pix, spp_local, med, surf, ill, dirs, ck,
                tgt, roff, ext,
                sample_offset=rank * spp_local, spp_stride=spp_stride,
            )
            return (rad_sum + rad, m2_sum + m2), None

        init = (
            jnp.zeros((S_local, n_pix), dtype),
            jnp.zeros((S_local, n_pix), dtype),
        )
        (rad, m2), _ = jax.lax.scan(chunk_body, init, jnp.arange(n_chunks))
        rad = jax.lax.pmean(rad, "sample")
        m2 = jax.lax.pmean(m2, "sample")
        return rad / n_chunks, m2 / n_chunks

    args = (medium, surface, illum, directions, row_keys,
            (target, ray_offset, target_extent))
    return jax.shard_map(
        shard_fn, mesh=mesh, in_specs=in_specs,
        out_specs=(P("spectral"), P("spectral")), check_vma=False,
    )(*args)


def render_sharded(scene, sensor, config, spp, seed=0, mesh=None, spp_chunk=None):
    """Sharded twin of :func:`eradiate_tpu.ops.tracer.render`.

    ``spp`` is the *total* per-pixel budget; each sample-axis device traces
    its contiguous slice of every pixel's global sample-id range, so the
    result equals the single-device render up to float summation order.
    """
    from ..ops.tracer import MAX_PATHS_PER_DISPATCH

    if mesh is None:
        mesh = make_render_mesh(1, len(jax.devices()))
    directions = jnp.asarray(sensor.directions)
    n_pix = directions.shape[0]
    S = scene.medium.tau_levels.shape[0]
    _, n_sample = _validate(mesh, S)

    # mirror ops.tracer.render's chunk plan (computed from the global budget)
    if config.sampler == "independent":
        n_chunks = 1
        spp_chunk = spp
    else:
        if spp_chunk is None:
            per_sample_paths = S * n_pix
            spp_chunk = max(1, MAX_PATHS_PER_DISPATCH // max(per_sample_paths, 1))
        spp_chunk = min(spp_chunk, spp)
        n_chunks = -(-spp // spp_chunk)
    spp_local = -(-spp_chunk // n_sample)
    traced = n_chunks * spp_local * n_sample

    row_keys = _row_keys(int(seed) & 0xFFFFFFFF, S)
    target = jnp.asarray(sensor.target)
    ray_offset = jnp.asarray(sensor.ray_offset)
    ext = (
        None if sensor.target_extent is None
        else jnp.asarray(sensor.target_extent)
    )
    args = (scene.medium, scene.surface, scene.illumination, directions,
            row_keys, target, ray_offset, ext)
    specs = (
        _medium_specs(scene.medium), _surface_specs(scene.surface),
        _illum_specs(scene.illumination), P(), P("spectral"), P(), P(),
        None if ext is None else P(),
    )
    args = _put_global(mesh, args, specs)
    rad, m2 = _pp_sharded(
        mesh, config, n_pix, spp_local, n_chunks, *args
    )
    return _fetch({"radiance": rad, "m2": m2, "spp": traced})


# ---------------------------------------------------------------------------
# plane-parallel polarized


def _scan_chunks(keys, n_chunks, run_chunk, zeros):
    """On-device chunk loop shared by every sharded family: ONE
    ``lax.scan`` over chunk ids inside the shard_map body, ONE ``pmean``
    per output AFTER the scan (the plane-parallel form of round 2,
    ``_pp_sharded``, generalized — VERDICT r2 task #6: previously the
    non-pp families ran a host-side chunk loop with one dispatch + one
    collective per chunk)."""
    S_local = keys.shape[0]

    def chunk_body(carry, chunk_id):
        ck = jax.vmap(jax.random.fold_in)(
            keys, jnp.full(S_local, chunk_id)
        )
        out = run_chunk(ck)
        return tuple(c + o for c, o in zip(carry, out)), None

    acc, _ = jax.lax.scan(chunk_body, zeros, jnp.arange(n_chunks))
    return tuple(jax.lax.pmean(a, "sample") / n_chunks for a in acc)


def _uniform_chunk_plan(spp, n_sample, spp_chunk):
    """Uniform chunks rounded up to cover the global budget (the
    ``render_sharded`` semantics: traced >= spp, every chunk equal)."""
    spp_chunk = min(spp_chunk or spp, spp)
    n_chunks = -(-spp // spp_chunk)
    spp_local = -(-spp_chunk // n_sample)
    traced = n_chunks * spp_local * n_sample
    return n_chunks, spp_local, traced


def _stokes_result(st, m2, traced):
    return {
        "stokes": st,
        "radiance": st[..., 0],
        "m2": m2,
        "spp": traced,
    }


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 4))
def _pp_polarized_sharded(
    mesh, config, n_pix, spp_local, n_chunks,
    medium, surface, illum, directions, row_keys,
):
    from ..ops.tracer_polarized import render_batch_polarized_impl

    spp_stride = spp_local * mesh.shape["sample"]
    dtype = medium.tau_levels.dtype
    in_specs = (
        _medium_specs(medium),
        _surface_specs(surface),
        _illum_specs(illum),
        P(),
        P("spectral"),
    )

    def shard_fn(med, surf, ill, dirs, keys):
        rank = jax.lax.axis_index("sample")
        S_local = keys.shape[0]
        zeros = (
            jnp.zeros((S_local, n_pix, 4), dtype),
            jnp.zeros((S_local, n_pix), dtype),
        )
        return _scan_chunks(
            keys, n_chunks,
            lambda ck: render_batch_polarized_impl(
                config, n_pix, spp_local, med, surf, ill, dirs, ck,
                sample_offset=rank * spp_local, spp_stride=spp_stride,
            ),
            zeros,
        )

    return jax.shard_map(
        shard_fn, mesh=mesh, in_specs=in_specs,
        out_specs=(P("spectral"), P("spectral")), check_vma=False,
    )(medium, surface, illum, directions, row_keys)


def render_polarized_sharded(
    scene, sensor, config, spp, seed=0, mesh=None, spp_chunk=None
):
    """Sharded twin of
    :func:`eradiate_tpu.ops.tracer_polarized.render_polarized`."""
    if mesh is None:
        mesh = make_render_mesh(1, len(jax.devices()))
    directions = jnp.asarray(sensor.directions)
    n_pix = directions.shape[0]
    S = scene.medium.tau_levels.shape[0]
    _, n_sample = _validate(mesh, S)
    n_chunks, spp_local, traced = _uniform_chunk_plan(spp, n_sample, spp_chunk)
    row_keys = _row_keys(int(seed) & 0xFFFFFFFF, S)

    args = (scene.medium, scene.surface, scene.illumination, directions,
            row_keys)
    specs = (
        _medium_specs(scene.medium), _surface_specs(scene.surface),
        _illum_specs(scene.illumination), P(), P("spectral"),
    )
    args = _put_global(mesh, args, specs)

    st, m2 = _pp_polarized_sharded(
        mesh, config, n_pix, spp_local, n_chunks, *args
    )
    return _fetch(_stokes_result(st, m2, traced))


# ---------------------------------------------------------------------------
# spherical shell (scalar + polarized)


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 4, 5, 6))
def _spherical_sharded(
    mesh, config, n_pix, spp_local, n_chunks, max_iterations, polarized,
    medium, surface, illum, directions, target, row_keys,
):
    spp_stride = spp_local * mesh.shape["sample"]
    dtype = medium.sigma_t.dtype
    in_specs = (
        _medium_specs(medium),
        _surface_specs(surface),
        _illum_specs(illum),
        P(),
        P(),
        P("spectral"),
    )
    if polarized:
        from ..ops.tracer_spherical_polarized import (
            render_batch_impl as impl,
        )
    else:
        from ..ops.tracer_spherical import (
            render_batch_spherical_impl as impl,
        )

    def shard_fn(med, surf, ill, dirs, tgt, keys):
        rank = jax.lax.axis_index("sample")
        S_local = keys.shape[0]
        lead = (S_local, n_pix, 4) if polarized else (S_local, n_pix)
        zeros = (jnp.zeros(lead, dtype), jnp.zeros((S_local, n_pix), dtype))
        return _scan_chunks(
            keys, n_chunks,
            lambda ck: impl(
                config, n_pix, spp_local, max_iterations, med, surf, ill,
                dirs, tgt, ck,
                sample_offset=rank * spp_local, spp_stride=spp_stride,
            ),
            zeros,
        )

    return jax.shard_map(
        shard_fn, mesh=mesh, in_specs=in_specs,
        out_specs=(P("spectral"), P("spectral")), check_vma=False,
    )(medium, surface, illum, directions, target, row_keys)


def _render_spherical_sharded_common(
    polarized, medium, surface, illum, sensor, config, spp, seed,
    max_iterations, mesh, spp_chunk,
):
    if mesh is None:
        mesh = make_render_mesh(1, len(jax.devices()))
    directions = jnp.asarray(sensor.directions)
    target = jnp.asarray(sensor.target)
    n_pix = directions.shape[0]
    S = medium.sigma_t.shape[0]
    _, n_sample = _validate(mesh, S)
    n_chunks, spp_local, traced = _uniform_chunk_plan(spp, n_sample, spp_chunk)
    row_keys = _row_keys(int(seed) & 0xFFFFFFFF, S)

    args = (medium, surface, illum, directions, target, row_keys)
    specs = (
        _medium_specs(medium), _surface_specs(surface), _illum_specs(illum),
        P(), P(), P("spectral"),
    )
    args = _put_global(mesh, args, specs)

    a, m2 = _spherical_sharded(
        mesh, config, n_pix, spp_local, n_chunks, max_iterations, polarized,
        *args,
    )
    if polarized:
        return _fetch(_stokes_result(a, m2, traced))
    return _fetch({"radiance": a, "m2": m2, "spp": traced})


def render_spherical_sharded(
    medium, surface, illum, sensor, config, spp, seed=0,
    max_iterations=512, mesh=None, spp_chunk=None,
):
    """Sharded twin of
    :func:`eradiate_tpu.ops.tracer_spherical.render_spherical`."""
    return _render_spherical_sharded_common(
        False, medium, surface, illum, sensor, config, spp, seed,
        max_iterations, mesh, spp_chunk,
    )


def render_spherical_polarized_sharded(
    medium, surface, illum, sensor, config, spp, seed=0,
    max_iterations=512, mesh=None, spp_chunk=None,
):
    """Sharded twin of ``render_spherical_polarized``."""
    return _render_spherical_sharded_common(
        True, medium, surface, illum, sensor, config, spp, seed,
        max_iterations, mesh, spp_chunk,
    )


# ---------------------------------------------------------------------------
# canopy (scalar + polarized) — leaf/triangle geometry replicates, the
# spectral optics tables shard


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 4, 5))
def _canopy_sharded(
    mesh, config, n_pix, spp_local, n_chunks, polarized,
    medium, surface, leaf_params, leaves, illum, directions, target,
    ray_offset, row_keys, tris, tri_params, target_extent,
):
    spp_stride = spp_local * mesh.shape["sample"]
    dtype = medium.tau_levels.dtype
    in_specs = (
        _medium_specs(medium),
        _surface_specs(surface),
        _spectral_specs(leaf_params),
        _replicated_specs(leaves),
        _illum_specs(illum),
        P(),
        P(),
        P(),
        P("spectral"),
        None if tris is None else _replicated_specs(tris),
        None if tri_params is None else _spectral_specs(tri_params),
        None if target_extent is None else P(),
    )
    if polarized:
        from ..ops.tracer_canopy_polarized import (
            render_batch_canopy_polarized_impl as impl,
        )
    else:
        from ..ops.tracer_canopy import render_batch_canopy_impl as impl

    def shard_fn(med, surf, lp_, lv, ill, dirs, tgt, roff, keys, tr, trp, ext):
        rank = jax.lax.axis_index("sample")
        S_local = keys.shape[0]
        lead = (S_local, n_pix, 4) if polarized else (S_local, n_pix)
        zeros = (jnp.zeros(lead, dtype), jnp.zeros((S_local, n_pix), dtype))
        return _scan_chunks(
            keys, n_chunks,
            lambda ck: impl(
                config, n_pix, spp_local, med, surf, lp_, lv, ill, dirs,
                tgt, roff, ck, tr, trp, ext,
                sample_offset=rank * spp_local, spp_stride=spp_stride,
            ),
            zeros,
        )

    return jax.shard_map(
        shard_fn, mesh=mesh, in_specs=in_specs,
        out_specs=(P("spectral"), P("spectral")), check_vma=False,
    )(medium, surface, leaf_params, leaves, illum, directions, target,
      ray_offset, row_keys, tris, tri_params, target_extent)


def _render_canopy_sharded_common(
    polarized, scene, leaf_params, leaves, sensor, config, spp, seed,
    mesh, spp_chunk, tris, tri_params,
):
    from ..ops.tracer import MAX_PATHS_PER_DISPATCH

    if mesh is None:
        mesh = make_render_mesh(1, len(jax.devices()))
    directions = jnp.asarray(sensor.directions)
    target = jnp.asarray(sensor.target)
    ray_offset = jnp.asarray(sensor.ray_offset)
    n_pix = directions.shape[0]
    S = scene.medium.tau_levels.shape[0]
    _, n_sample = _validate(mesh, S)

    if spp_chunk is None:
        # same global heuristic as the single-device entries
        max_spp = max(1, (MAX_PATHS_PER_DISPATCH // 8) // max(S * n_pix, 1))
        if spp > max_spp:
            spp_chunk = max_spp
    n_chunks, spp_local, traced = _uniform_chunk_plan(spp, n_sample, spp_chunk)

    row_keys = _row_keys(int(seed) & 0xFFFFFFFF, S)
    ext = (
        None if sensor.target_extent is None
        else jnp.asarray(sensor.target_extent)
    )

    args = (scene.medium, scene.surface, leaf_params, leaves,
            scene.illumination, directions, target, ray_offset, row_keys,
            tris, tri_params, ext)
    specs = (
        _medium_specs(scene.medium), _surface_specs(scene.surface),
        _spectral_specs(leaf_params), _replicated_specs(leaves),
        _illum_specs(scene.illumination), P(), P(), P(), P("spectral"),
        None if tris is None else _replicated_specs(tris),
        None if tri_params is None else _spectral_specs(tri_params),
        None if ext is None else P(),
    )
    args = _put_global(mesh, args, specs)

    a, m2 = _canopy_sharded(
        mesh, config, n_pix, spp_local, n_chunks, polarized, *args
    )
    if polarized:
        return _fetch(_stokes_result(a, m2, traced))
    return _fetch({"radiance": a, "m2": m2, "spp": traced})


def render_canopy_sharded(
    scene, leaf_params, leaves, sensor, config, spp, seed=0,
    mesh=None, spp_chunk=None, tris=None, tri_params=None,
):
    """Sharded twin of
    :func:`eradiate_tpu.ops.tracer_canopy.render_canopy`."""
    return _render_canopy_sharded_common(
        False, scene, leaf_params, leaves, sensor, config, spp, seed, mesh,
        spp_chunk, tris, tri_params,
    )


def render_canopy_polarized_sharded(
    scene, leaf_params, leaves, sensor, config, spp, seed=0,
    mesh=None, spp_chunk=None, tris=None, tri_params=None,
):
    """Sharded twin of ``render_canopy_polarized``."""
    return _render_canopy_sharded_common(
        True, scene, leaf_params, leaves, sensor, config, spp, seed, mesh,
        spp_chunk, tris, tri_params,
    )


# ---------------------------------------------------------------------------
# DEM


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 4))
def _dem_sharded(
    mesh, config, n_pix, spp_local, n_chunks,
    medium, surface, dem, illum, directions, target, ray_offset, row_keys,
    target_extent,
):
    from ..ops.tracer_dem import render_batch_dem_impl

    spp_stride = spp_local * mesh.shape["sample"]
    dtype = medium.tau_levels.dtype
    in_specs = (
        _medium_specs(medium),
        _surface_specs(surface),
        _replicated_specs(dem),
        _illum_specs(illum),
        P(),
        P(),
        P(),
        P("spectral"),
        None if target_extent is None else P(),
    )

    def shard_fn(med, surf, dm, ill, dirs, tgt, roff, keys, ext):
        rank = jax.lax.axis_index("sample")
        S_local = keys.shape[0]
        zeros = (
            jnp.zeros((S_local, n_pix), dtype),
            jnp.zeros((S_local, n_pix), dtype),
        )
        return _scan_chunks(
            keys, n_chunks,
            lambda ck: render_batch_dem_impl(
                config, n_pix, spp_local, med, surf, dm, ill, dirs, tgt,
                roff, ck, ext,
                sample_offset=rank * spp_local, spp_stride=spp_stride,
            ),
            zeros,
        )

    return jax.shard_map(
        shard_fn, mesh=mesh, in_specs=in_specs,
        out_specs=(P("spectral"), P("spectral")), check_vma=False,
    )(medium, surface, dem, illum, directions, target, ray_offset, row_keys,
      target_extent)


def render_dem_sharded(
    scene, dem, sensor, config, spp, seed=0, mesh=None, spp_chunk=None
):
    """Sharded twin of :func:`eradiate_tpu.ops.tracer_dem.render_dem`."""
    from ..ops.tracer import MAX_PATHS_PER_DISPATCH

    if mesh is None:
        mesh = make_render_mesh(1, len(jax.devices()))
    directions = jnp.asarray(sensor.directions)
    target = jnp.asarray(sensor.target)
    ray_offset = jnp.asarray(sensor.ray_offset)
    n_pix = directions.shape[0]
    S = scene.medium.tau_levels.shape[0]
    _, n_sample = _validate(mesh, S)

    if spp_chunk is None:
        max_spp = max(1, (MAX_PATHS_PER_DISPATCH // 16) // max(S * n_pix, 1))
        if spp > max_spp:
            spp_chunk = max_spp
    n_chunks, spp_local, traced = _uniform_chunk_plan(spp, n_sample, spp_chunk)

    row_keys = _row_keys(int(seed) & 0xFFFFFFFF, S)
    ext = (
        None if sensor.target_extent is None
        else jnp.asarray(sensor.target_extent)
    )

    args = (scene.medium, scene.surface, dem, scene.illumination, directions,
            target, ray_offset, row_keys, ext)
    specs = (
        _medium_specs(scene.medium), _surface_specs(scene.surface),
        _replicated_specs(dem), _illum_specs(scene.illumination), P(), P(),
        P(), P("spectral"), None if ext is None else P(),
    )
    args = _put_global(mesh, args, specs)

    rad, m2 = _dem_sharded(mesh, config, n_pix, spp_local, n_chunks, *args)
    return _fetch({"radiance": rad, "m2": m2, "spp": traced})
