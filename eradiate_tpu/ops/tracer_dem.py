"""Wavefront path tracer — terrain (DEM) surfaces under a 1D atmosphere.

Mirror of the reference's ``DEMExperiment`` rendering path
(``experiments/_dem.py:39``: 1D atmosphere + triangulated DEM surface).
The terrain is a bilinear heightfield (:mod:`eradiate_tpu.ops.dem`);
every candidate free-flight segment is tested against it, and NEE casts
terrain-occlusion shadow rays (self-shadowing at low sun).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .fastrng import bounce_uniforms, derive_keys, origin_uniforms

from .bsdf_ops import bsdf_eval, bsdf_sample_from_uniforms
from .dem import DemArrays, dem_intersect, dem_normal
from .medium import clamp_mu, take_1d, tau_at_z, z_at_tau
from .phase_ops import ortho_frame, phase_eval, phase_sample_from_uniforms
from .scene_state import (
    IlluminationArrays,
    MediumArrays,
    SceneConfig,
    SensorArrays,
    SurfaceArrays,
)

__all__ = ["render_dem"]


def _to_world(n, v):
    t1, t2 = ortho_frame(n)
    return t1 * v[..., 0:1] + t2 * v[..., 1:2] + n * v[..., 2:3]


def _to_local(n, v):
    t1, t2 = ortho_frame(n)
    return jnp.stack(
        [jnp.sum(t1 * v, -1), jnp.sum(t2 * v, -1), jnp.sum(n * v, -1)], axis=-1
    )


def _make_bounce_dem(config: SceneConfig, medium_row, surface_row, dem, illum_row,
                     tris=None, n_march=128, n_bisect=16):
    """Per-bounce transition closure shared by the one-shot and
    regenerative DEM loops (see ops/tracer._make_bounce).

    ``tris``: optional triangulated terrain
    (:func:`eradiate_tpu.ops.dem.mesh_from_dem`) — the reference's exact
    triangle-mesh DEM path (``scenes/surface/_dem.py:475``). When given,
    surface intersections and shadow rays run through the Moeller-
    Trumbore engine (:mod:`eradiate_tpu.ops.mesh`) instead of the
    marched bilinear heightfield; normals come from the hit triangle.
    The A/B of the two intersectors inside one estimator is the
    marcher's exactness cross-gate (tests/system/test_dem.py)."""
    z_levels = medium_row.z_levels
    tau_levels = medium_row.tau_levels
    tau_top = tau_levels[-1]
    z_bottom = z_levels[0]
    z_top = z_levels[-1]
    # likelihood-ratio flight (see ops/tracer._make_bounce): sampling
    # geometry is DETACHED and the medium's parameter dependence
    # re-enters through primal-neutral ratio weights, making forward-
    # mode extinction derivatives unbiased. The DEM estimator adds one
    # event family over the plane-parallel tracer: a terrain hit at
    # depth tau_path occurs with probability exp(-tau_path), so its
    # ratio weight is exp(-(tau_path - sg(tau_path))) — primal 1.0.
    _lr = bool(getattr(config, "lr_flight", False))
    sg = jax.lax.stop_gradient if _lr else (lambda x: x)
    dtau_layers = jnp.diff(tau_levels)

    d_sun = illum_row.direction
    mu_sun = clamp_mu(-d_sun[2])
    w_sun = -d_sun
    E_sun = illum_row.irradiance
    shadow_range = 2.0 * (z_top - z_bottom) / jnp.maximum(mu_sun, 0.05)

    def tau_z(z):
        return tau_at_z(z, z_levels, tau_levels)

    if tris is not None:
        from .mesh import tri_bounds, tri_nearest, tri_occluded

        # the AABB is loop-invariant: build it once here rather than
        # inside the while_loop body (XLA does not reliably hoist it)
        tri_box = tri_bounds(tris)

    def sun_T(pos):
        T_atm = jnp.exp(-(tau_top - tau_z(pos[:, 2])) / mu_sun)
        if tris is not None:
            hit = tri_occluded(
                pos,
                jnp.broadcast_to(w_sun, pos.shape),
                jnp.full(pos.shape[0], shadow_range),
                tris,
                bounds=tri_box,
            )
        else:
            _, hit = dem_intersect(
                dem,
                pos,
                jnp.broadcast_to(w_sun, pos.shape),
                jnp.full(pos.shape[0], shadow_range),
                n_march=n_march,
                n_bisect=n_bisect,
            )
        return T_atm * jnp.where(hit, 0.0, 1.0)

    eps = 1e-5

    def bounce(depth_b, pos, d, beta, keys):
        # one batched threefry draw per bounce (see ops/tracer._make_bounce)
        U = bounce_uniforms(config.rng, keys, depth_b, 8)
        u_dist = U[:, 0]
        u_sel, u_cos, u_phi = U[:, 1], U[:, 2:4], U[:, 4]
        u_srf = U[:, 5:7]
        u_rr = U[:, 7]

        z = pos[:, 2]
        mu = clamp_mu(d[:, 2])
        tau_here = tau_z(z)
        tau_here_s = sg(tau_here)
        tau_top_s = sg(tau_top)
        tau_exit = jnp.where(
            mu > 0.0, (tau_top_s - tau_here_s) / mu, tau_here_s / (-mu)
        )
        tau_s = -jnp.log1p(-u_dist)
        collide_med = tau_s < tau_exit

        tau_new = jnp.clip(tau_here_s + mu * tau_s, 0.0, tau_top_s)
        z_med, layer = z_at_tau(tau_new, z_levels, sg(tau_levels))
        z_edge = jnp.where(mu > 0.0, z_top, z_bottom)
        t_cand = jnp.where(collide_med, (z_med - z) / mu, (z_edge - z) / mu)
        t_cand = jnp.maximum(t_cand, eps)

        if tris is not None:
            # same overshoot as the marcher (dem_intersect): the f32
            # candidate endpoint can land marginally short of a grazed
            # or boundary-coincident surface
            t_dem, n_tri, hit_dem = tri_nearest(
                pos, d, t_cand * 1.02 + 1e-4, tris, bounds=tri_box
            )
        else:
            t_dem, hit_dem = dem_intersect(
                dem, pos, d, t_cand, n_march=n_march, n_bisect=n_bisect
            )

        event_dem = hit_dem & config.has_surface
        event_med = collide_med & ~event_dem

        pos_dem = pos + d * t_dem[:, None]
        pos_med = pos + d * t_cand[:, None]

        if _lr:
            # collision density sigma(z) exp(-tau_path) at the FIXED
            # sampled altitude (sigma ratio via the layer's attached
            # dtau: dz is theta-independent and constants cancel in the
            # primal-neutral exp(g - sg(g)) form); terrain-hit
            # probability exp(-tau_path_to_hit). All path depths use the
            # attached tau(z) profile at detached geometry.
            abs_mu = jnp.abs(mu)
            dtau_att = take_1d(dtau_layers, layer)
            tau_path_col = jnp.abs(tau_z(z_med) - tau_here) / abs_mu
            g_col = jnp.log(jnp.maximum(dtau_att, 1e-30)) - tau_path_col
            r_col = jnp.exp(g_col - sg(g_col))  # primal exactly 1.0
            tau_path_dem = jnp.abs(tau_z(pos_dem[:, 2]) - tau_here) / abs_mu
            r_dem = jnp.exp(-(tau_path_dem - sg(tau_path_dem)))
        else:
            r_col = r_dem = 1.0

        # ---- medium collision ------------------------------------------
        albedo_col = take_1d(medium_row.albedo, layer)
        cos_nee = -jnp.sum(d_sun * d, axis=-1)
        p_nee = jax.vmap(
            lambda l, c: phase_eval(
                config.phase_kinds, medium_row.phase_params,
                medium_row.phase_weights, l, c,
            )
        )(layer, cos_nee)
        L_med = beta * r_col * albedo_col * p_nee * sun_T(pos_med) * E_sun
        d_med = jax.vmap(
            lambda l, dd, us, uc, up: phase_sample_from_uniforms(
                config.phase_kinds, medium_row.phase_params,
                medium_row.phase_weights, l, dd, us, uc, up,
            )
        )(layer, d, u_sel, u_cos, u_phi)
        beta_med = beta * r_col * albedo_col

        # ---- terrain hit ------------------------------------------------
        if tris is not None:
            # orient the geometric triangle normal upward-facing toward
            # the incoming ray (terrain is single-sided from above)
            flip = jnp.sum(n_tri * d, axis=-1) > 0.0
            n_srf = jnp.where(flip[:, None], -n_tri, n_tri)
        else:
            n_srf = dem_normal(dem, pos_dem[:, 0], pos_dem[:, 1])
        wo_l = _to_local(n_srf, -d)
        wi_sun_l = _to_local(n_srf, jnp.broadcast_to(w_sun, d.shape))
        f_nee = bsdf_eval(config.surface_kind, surface_row.params, wi_sun_l, wo_l, pos_dem[:, :2])
        cos_sun = jnp.maximum(jnp.sum(n_srf * w_sun, axis=-1), 0.0)
        pos_dem_off = pos_dem + n_srf * eps
        L_dem = beta * r_dem * f_nee * cos_sun * sun_T(pos_dem_off) * E_sun
        d_srf_l, w_srf = bsdf_sample_from_uniforms(
            config.surface_kind, surface_row.params, wo_l, u_srf,
            pos_dem[:, :2],
        )
        d_srf = _to_world(n_srf, d_srf_l)
        beta_srf = beta * r_dem * w_srf

        # ---- combine ----------------------------------------------------
        L_add = jnp.where(event_dem, L_dem, jnp.where(event_med, L_med, 0.0))
        pos2 = jnp.where(event_dem[:, None], pos_dem_off, pos_med)
        d2 = jnp.where(event_dem[:, None], d_srf, jnp.where(event_med[:, None], d_med, d))
        beta2 = jnp.where(event_dem, beta_srf, jnp.where(event_med, beta_med, 0.0))
        alive2 = (event_dem | event_med) & (beta2 > 0.0)

        do_rr = depth_b >= config.rr_depth
        q = jnp.clip(beta2, 0.0, 0.95)
        survive = u_rr < q
        beta2 = jnp.where(do_rr & alive2 & survive, beta2 / q, beta2)
        alive2 = alive2 & jnp.where(do_rr, survive, True)

        return L_add, pos2, d2, beta2, alive2

    return bounce


def trace_paths_dem(
    config: SceneConfig,
    medium_row,
    surface_row,
    dem: DemArrays,
    illum_row,
    init_pos,
    init_d,
    keys,
):
    """One-shot loop: one sample per lane (reference implementation)."""
    B = init_pos.shape[0]
    bounce = _make_bounce_dem(
        config, medium_row, surface_row, dem, illum_row
    )

    def body(carry):
        depth, pos, d, beta, L, alive, keys = carry
        L_add, pos2, d2, beta2, alive2 = bounce(
            jnp.full(B, depth), pos, d, beta, keys
        )
        L = L + jnp.where(alive, L_add, 0.0)
        alive = alive & alive2
        return (depth + 1, pos2, d2, beta2, L, alive, keys)

    def cond(carry):
        return (carry[0] < config.max_depth) & jnp.any(carry[5])

    init = (
        jnp.asarray(0),
        init_pos,
        init_d,
        jnp.ones(B, init_pos.dtype),
        jnp.zeros(B, init_pos.dtype),
        jnp.ones(B, dtype=bool),
        keys,
    )
    final = jax.lax.while_loop(cond, body, init)
    return final[4]


def trace_paths_dem_regen(
    config: SceneConfig,
    medium_row,
    surface_row,
    dem: DemArrays,
    illum_row,
    init_pos,
    init_d,
    row_key,
    lane_first,
    quota,
    ext=None,
    tris=None,
    n_march=128,
    n_bisect=16,
):
    """Regenerative DEM trace (see ops/tracer.trace_paths_regen)."""
    B = init_pos.shape[0]
    dtype = init_pos.dtype
    bounce = _make_bounce_dem(
        config, medium_row, surface_row, dem, illum_row, tris=tris,
        n_march=n_march, n_bisect=n_bisect,
    )
    row_keys_b = jnp.broadcast_to(row_key, (B,))

    def sample_key(s_local):
        return derive_keys(config.rng, row_keys_b, lane_first + s_local)

    def origin(keys):
        if ext is None:
            return init_pos
        u = origin_uniforms(config.rng, keys, 2, dtype=dtype)
        jit = (u - 0.5) * ext
        return init_pos + jnp.concatenate(
            [jit, jnp.zeros((B, 1), dtype)], axis=-1
        )

    def body(carry):
        (s_local, depth, pos, d, beta, L_cur, keys, done,
         L_sum, m2_sum) = carry

        L_add, pos2, d2, beta2, alive2 = bounce(depth, pos, d, beta, keys)
        active = ~done
        L_cur = L_cur + jnp.where(active, L_add, 0.0)
        depth = depth + 1
        path_end = active & (~alive2 | (depth >= config.max_depth))

        L_sum = L_sum + jnp.where(path_end, L_cur, 0.0)
        m2_sum = m2_sum + jnp.where(path_end, L_cur * L_cur, 0.0)
        s_local = s_local + path_end.astype(s_local.dtype)
        done = done | (s_local >= quota)

        regen = path_end & ~done
        keys_new = sample_key(s_local)
        keys = jnp.where(regen, keys_new, keys)
        pos = jnp.where(regen[:, None], origin(keys_new), pos2)
        d = jnp.where(regen[:, None], init_d, d2)
        beta = jnp.where(regen, jnp.ones((), dtype), beta2)
        L_cur = jnp.where(path_end, 0.0, L_cur)
        depth = jnp.where(regen, 0, depth)

        return (s_local, depth, pos, d, beta, L_cur, keys, done,
                L_sum, m2_sum)

    def cond(carry):
        return jnp.any(~carry[7])

    keys0 = sample_key(jnp.zeros(B, jnp.int32))
    init = (
        jnp.zeros(B, jnp.int32),
        jnp.zeros(B, jnp.int32),
        origin(keys0),
        init_d,
        jnp.ones(B, dtype),
        jnp.zeros(B, dtype),
        keys0,
        jnp.zeros(B, dtype=bool),
        jnp.zeros(B, dtype),
        jnp.zeros(B, dtype),
    )
    final = jax.lax.while_loop(cond, body, init)
    return final[8], final[9]


def _render_row_dem(
    config, n_pix, spp, medium_row, surface_row, dem, illum_row, directions,
    target, ray_offset, key, target_extent=None, sample_offset=None,
    spp_stride=None, tris=None, n_march=128, n_bisect=16,
):
    from .tracer import _per_path_targets, lane_partition

    lp, pix, slot, lane_first, quota = lane_partition(
        n_pix, spp, spp_stride=spp_stride, sample_offset=sample_offset
    )
    B = n_pix * lp
    z_top = medium_row.z_levels[-1]
    w_v = directions[pix]
    tgt = _per_path_targets(target, None, pix, key, w_v.dtype)
    if target_extent is not None:
        ext = (
            target_extent[pix]
            if target_extent.ndim == 2
            else jnp.broadcast_to(target_extent, (B, 2))
        )
    else:
        ext = None
    # TOA start through target, or target + ray_offset * w_v (cameras)
    t_up = jnp.where(
        jnp.isnan(ray_offset),
        (z_top - tgt[:, 2]) / jnp.maximum(w_v[:, 2], 1e-6),
        ray_offset,
    )
    init_pos = tgt + w_v * t_up[:, None]
    init_d = -w_v
    L_sum, m2_sum = trace_paths_dem_regen(
        config, medium_row, surface_row, dem, illum_row, init_pos, init_d,
        key, lane_first, quota, ext=ext, tris=tris, n_march=n_march,
        n_bisect=n_bisect,
    )
    radiance = jnp.sum(L_sum.reshape(n_pix, lp), axis=1) / spp
    m2 = jnp.sum(m2_sum.reshape(n_pix, lp), axis=1) / spp
    return radiance, m2


def render_batch_dem_impl(
    config, n_pix, spp, medium, surface, dem, illum, directions, target,
    ray_offset, keys, target_extent=None, sample_offset=None, spp_stride=None,
    tris=None, n_march=128, n_bisect=16,
):
    # lax.map, not vmap: vmapping the while_loop defeats XLA's fusion of
    # the masked table lookups (see ops/tracer.render_batch_impl)
    z_levels = medium.z_levels

    def one_row(args):
        mr_part, sr, irr, sky, k = args
        mr = MediumArrays(
            z_levels=z_levels,
            tau_levels=mr_part[0],
            albedo=mr_part[1],
            phase_weights=mr_part[2],
            phase_params=mr_part[3],
        )
        ir = IlluminationArrays(
            direction=illum.direction,
            irradiance=irr,
            cos_cutoff=illum.cos_cutoff,
            sky_radiance=sky,
        )
        return _render_row_dem(
            config, n_pix, spp, mr, sr, dem, ir, directions, target,
            ray_offset, k, target_extent, sample_offset=sample_offset,
            spp_stride=spp_stride, tris=tris, n_march=n_march,
            n_bisect=n_bisect,
        )

    med_part = (
        medium.tau_levels,
        medium.albedo,
        medium.phase_weights,
        medium.phase_params,
    )
    return jax.lax.map(
        one_row, (med_part, surface, illum.irradiance, illum.sky_radiance, keys)
    )


_render_batch_dem = jax.jit(
    render_batch_dem_impl,
    static_argnums=(0, 1, 2),
    static_argnames=("n_march", "n_bisect"),
)


def render_dem(scene, dem: DemArrays, sensor: SensorArrays, config: SceneConfig,
               spp: int, seed: int = 0, spp_chunk: int | None = None,
               tris=None, n_march=128, n_bisect=16):
    from .tracer import MAX_PATHS_PER_DISPATCH

    directions = jnp.asarray(sensor.directions)
    target = jnp.asarray(sensor.target)
    ray_offset = jnp.asarray(sensor.ray_offset)
    n_pix = directions.shape[0]
    S = scene.medium.tau_levels.shape[0]

    if spp_chunk is None:
        max_spp = max(1, (MAX_PATHS_PER_DISPATCH // 16) // max(S * n_pix, 1))
        if spp > max_spp:
            spp_chunk = max_spp

    base_key = jax.random.key(seed)
    row_keys = jax.vmap(jax.random.fold_in)(
        jnp.broadcast_to(base_key, (S,)), jnp.arange(S)
    )

    chunks = []
    start = 0
    step = spp_chunk or spp
    while start < spp:
        chunks.append(min(step, spp - start))
        start += step

    rad_sum = jnp.zeros((S, n_pix))
    m2_sum = jnp.zeros((S, n_pix))
    traced = 0
    for chunk_id, n in enumerate(chunks):
        chunk_keys = jax.vmap(jax.random.fold_in)(row_keys, jnp.full(S, chunk_id))
        rad, m2 = _render_batch_dem(
            config, n_pix, n, scene.medium, scene.surface, dem,
            scene.illumination, directions, target, ray_offset, chunk_keys,
            None
            if sensor.target_extent is None
            else jnp.asarray(sensor.target_extent),
            None,
            None,
            tris,
            n_march=int(n_march),
            n_bisect=int(n_bisect),
        )
        rad_sum = rad_sum + rad * n
        m2_sum = m2_sum + m2 * n
        traced += n

    return {"radiance": rad_sum / traced, "m2": m2_sum / traced, "spp": traced}
