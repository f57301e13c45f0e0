"""Triangle-mesh geometry kernels: ray / triangle intersection.

JAX replacement for the reference's triangle-mesh + BVH tracing (SURVEY
§2.1: Embree-optional surface intersection; mesh shapes
``scenes/shapes/_filemesh.py`` / ``_buffermesh.py``, mesh trees
``scenes/biosphere/_tree.py``). Same design as the leaf-disk sweep
(:mod:`eradiate_tpu.ops.canopy`): no BVH — the [paths x triangles] grid is
evaluated in fixed-size chunks with branchless Moller-Trumbore, as dense
regular elementwise compute.

Storage is pre-differenced for the hot loop: v0 [N, 3] plus edge vectors
e1 = v1 - v0, e2 = v2 - v0. Lengths in km (kernel units).
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from .scene_state import _pytree_dataclass

__all__ = [
    "InstancedTriArrays",
    "TriangleMeshArrays",
    "mesh_from_vertices",
    "ray_tris_nearest",
    "ray_tris_occluded",
    "tri_bounds",
    "tri_nearest",
    "tri_occluded",
    "cylinder_mesh",
    "cone_mesh",
]


@_pytree_dataclass
class TriangleMeshArrays:
    v0: Any  # [N, 3]
    e1: Any  # [N, 3]
    e2: Any  # [N, 3]


@_pytree_dataclass
class InstancedTriArrays:
    """Instanced triangle geometry: one canonical soup + per-instance
    translations (the sweeps scan instances; see
    ops/canopy.InstancedLeafArrays for the design)."""

    canonical: TriangleMeshArrays
    offsets: Any  # [I, 3]


def mesh_from_vertices(vertices, faces) -> TriangleMeshArrays:
    """Build device arrays from [V, 3] vertices and [N, 3] integer faces."""
    vertices = jnp.asarray(vertices)
    faces = np.asarray(faces, dtype=np.int64)
    v0 = vertices[faces[:, 0]]
    v1 = vertices[faces[:, 1]]
    v2 = vertices[faces[:, 2]]
    return TriangleMeshArrays(v0=v0, e1=v1 - v0, e2=v2 - v0)


_EPS_T = 1e-7


def _chunk_hits(p, d, v0, e1, e2, t_max):
    """Moller-Trumbore distances of rays [B, 3] against a triangle chunk
    [Nc]. Returns t [B, Nc] with +inf where missed."""
    # pvec = d x e2 ; det = e1 . pvec. The 3-vector dots are elementwise
    # multiply-and-sum: exact f32 on every backend, no matmul precision
    pvec = jnp.cross(d[:, None, :], e2[None, :, :])  # [B, Nc, 3]
    det = jnp.sum(e1[None, :, :] * pvec, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / det, 0.0)
    tvec = p[:, None, :] - v0[None, :, :]
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1[None, :, :])
    v = jnp.sum(d[:, None, :] * qvec, axis=-1) * inv_det
    t = jnp.sum(e2[None, :, :] * qvec, axis=-1) * inv_det
    ok = (
        (jnp.abs(det) > 1e-12)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > _EPS_T)
        & (t < t_max[:, None])
    )
    return jnp.where(ok, t, jnp.inf)


def _scan_chunks(p, d, tris, t_max, chunk, reduce_fn, init):
    N = tris.v0.shape[0]
    n_chunks = -(-N // chunk)
    pad = n_chunks * chunk - N

    def padded(a):
        if not pad:
            return a
        # degenerate far-away triangles never hit
        ext = jnp.full((pad, 3), 0.0, dtype=a.dtype)
        return jnp.concatenate([a, ext], axis=0)

    v0 = padded(tris.v0)
    if pad:
        v0 = v0.at[N:, 2].set(-1e9)
    e1 = padded(tris.e1)
    e2 = padded(tris.e2)

    vv = v0.reshape(n_chunks, chunk, 3)
    aa = e1.reshape(n_chunks, chunk, 3)
    bb = e2.reshape(n_chunks, chunk, 3)

    def body(carry, xs):
        v, a, b = xs
        t = _chunk_hits(p, d, v, a, b, t_max)
        return reduce_fn(carry, t, xs), None

    carry, _ = jax.lax.scan(body, init, (vv, aa, bb))
    return carry


def ray_tris_nearest(p, d, t_max, tris: TriangleMeshArrays, chunk: int = 512):
    """Nearest triangle hit along p + t d for t in (0, t_max).

    Returns (t_hit [B], geometric_normal [B, 3] (unit), hit [B]).
    """
    B = p.shape[0]

    def reduce_fn(carry, t, xs):
        best_t, best_n = carry
        v, a, b = xs
        # gather-free winner selection (see ops/canopy.ray_leaves_nearest)
        n_tri = jnp.cross(a, b)  # [Nc, 3]
        n_tri = n_tri / jnp.maximum(
            jnp.linalg.norm(n_tri, axis=-1, keepdims=True), 1e-12
        )
        tmin = jnp.min(t, axis=1)
        m = (t == tmin[:, None]) & jnp.isfinite(tmin)[:, None]
        cnt = jnp.maximum(jnp.sum(m, axis=1), 1)
        n_sel = jnp.stack(
            [
                jnp.sum(jnp.where(m, n_tri[None, :, j], 0.0), axis=1)
                for j in range(3)
            ],
            axis=-1,
        ) / cnt[:, None].astype(t.dtype)
        better = tmin < best_t
        best_n = jnp.where(better[:, None], n_sel, best_n)
        best_t = jnp.where(better, tmin, best_t)
        return best_t, best_n

    init = (jnp.full(B, jnp.inf), jnp.zeros((B, 3)).at[:, 2].set(1.0))
    best_t, best_n = _scan_chunks(p, d, tris, t_max, chunk, reduce_fn, init)
    hit = jnp.isfinite(best_t)
    return jnp.where(hit, best_t, t_max), best_n, hit


def ray_tris_occluded(p, d, t_max, tris: TriangleMeshArrays, chunk: int = 512):
    """True where any triangle blocks the segment (shadow rays)."""

    def reduce_fn(carry, t, xs):
        return carry | jnp.any(jnp.isfinite(t), axis=1)

    return _scan_chunks(
        p, d, tris, t_max, chunk, reduce_fn, jnp.zeros(p.shape[0], dtype=bool)
    )


def tri_bounds(tris):
    """(lo, hi) AABB of the triangle set (flat or instanced). Compute it
    ONCE per render (outside the path loop) and pass it to
    :func:`tri_nearest`/:func:`tri_occluded`."""
    base = tris.canonical if isinstance(tris, InstancedTriArrays) else tris
    verts = jnp.concatenate(
        [base.v0, base.v0 + base.e1, base.v0 + base.e2], axis=0
    )
    lo = jnp.min(verts, axis=0)
    hi = jnp.max(verts, axis=0)
    if isinstance(tris, InstancedTriArrays):
        lo = lo + jnp.min(tris.offsets, axis=0)
        hi = hi + jnp.max(tris.offsets, axis=0)
    return lo, hi


def _instanced_tris_nearest(p, d, t_max, inst):
    c = inst.canonical
    B = p.shape[0]

    def body(carry, offset):
        best_t, best_n, any_hit = carry
        t, n, h = ray_tris_nearest(p - offset[None, :], d, best_t, c)
        better = h & (t < best_t)
        best_t = jnp.where(better, t, best_t)
        best_n = jnp.where(better[:, None], n, best_n)
        return (best_t, best_n, any_hit | better), None

    init = (
        t_max,
        jnp.zeros((B, 3), p.dtype).at[:, 2].set(1.0),
        jnp.zeros(B, dtype=bool),
    )
    (best_t, best_n, hit), _ = jax.lax.scan(body, init, inst.offsets)
    return jnp.where(hit, best_t, t_max), best_n, hit


def tri_nearest(p, d, t_max, tris, bounds=None):
    """Nearest triangle hit with AABB-advanced origins (precision at
    TOA-distant ray starts + whole-lane culling; see
    ops/canopy._advance_to_aabb), then the dense sweep (instance scan for
    instanced sets). ``bounds``: :func:`tri_bounds` of ``tris``."""
    from .canopy import _advance_to_aabb

    lo, hi = bounds if bounds is not None else tri_bounds(tris)
    p_adv, t0, t_cap = _advance_to_aabb(p, d, t_max, lo, hi)
    if isinstance(tris, InstancedTriArrays):
        t_loc, n, hit = _instanced_tris_nearest(p_adv, d, t_cap, tris)
    else:
        t_loc, n, hit = ray_tris_nearest(p_adv, d, t_cap, tris)
    return jnp.where(hit, t0 + t_loc, t_max), n, hit


def tri_occluded(p, d, t_max, tris, bounds=None):
    """Shadow-ray any-hit with AABB advance (instance scan for instanced
    sets); ``bounds`` as in :func:`tri_nearest`."""
    from .canopy import _advance_to_aabb

    lo, hi = bounds if bounds is not None else tri_bounds(tris)
    p_adv, t0, t_cap = _advance_to_aabb(p, d, t_max, lo, hi)
    if isinstance(tris, InstancedTriArrays):
        c = tris.canonical

        def body(carry, offset):
            return carry | ray_tris_occluded(
                p_adv - offset[None, :], d, t_cap, c
            ), None

        occ, _ = jax.lax.scan(
            body, jnp.zeros(p.shape[0], dtype=bool), tris.offsets
        )
        return occ
    return ray_tris_occluded(p_adv, d, t_cap, tris)


# ---------------------------------------------------------------------------
# Procedural meshes (host-side numpy; trunk/branch primitives for trees,
# reference ``scenes/biosphere/_tree.py``)
# ---------------------------------------------------------------------------


def cylinder_mesh(radius, height, center=(0.0, 0.0, 0.0), n_seg=12, cap=True):
    """Closed cylinder (axis +z) as (vertices [V, 3], faces [N, 3])."""
    c = np.asarray(center, dtype=np.float64)
    ang = np.linspace(0.0, 2.0 * np.pi, n_seg, endpoint=False)
    ring = np.stack([np.cos(ang) * radius, np.sin(ang) * radius], axis=-1)
    bot = np.concatenate([ring, np.zeros((n_seg, 1))], axis=-1) + c
    top = bot + np.array([0.0, 0.0, height])
    verts = [bot, top]
    faces = []
    for i in range(n_seg):
        j = (i + 1) % n_seg
        faces.append([i, j, n_seg + i])
        faces.append([j, n_seg + j, n_seg + i])
    if cap:
        verts.append((c + np.array([0.0, 0.0, height]))[None, :])
        apex = 2 * n_seg
        for i in range(n_seg):
            j = (i + 1) % n_seg
            faces.append([n_seg + i, n_seg + j, apex])
    return np.concatenate(verts, axis=0), np.asarray(faces, dtype=np.int64)


def cone_mesh(radius, height, center=(0.0, 0.0, 0.0), n_seg=12):
    """Open cone (apex up, axis +z) as (vertices, faces)."""
    c = np.asarray(center, dtype=np.float64)
    ang = np.linspace(0.0, 2.0 * np.pi, n_seg, endpoint=False)
    ring = np.stack(
        [np.cos(ang) * radius, np.sin(ang) * radius, np.zeros(n_seg)], axis=-1
    ) + c
    apex = (c + np.array([0.0, 0.0, height]))[None, :]
    verts = np.concatenate([ring, apex], axis=0)
    faces = [[i, (i + 1) % n_seg, n_seg] for i in range(n_seg)]
    return verts, np.asarray(faces, dtype=np.int64)
