"""Wavefront path tracer — polarized canopy scenes (leaf clouds + ground
+ optional 1D atmosphere), plane-parallel geometry.

Completes BASELINE config 5 (coupled canopy + atmosphere with polarized
transport; reference ``*_polarized`` variants over
``CanopyAtmosphereExperiment``, ``experiments/_canopy_atmosphere.py:47``).
Event structure mirrors the scalar canopy tracer
(:mod:`eradiate_tpu.ops.tracer_canopy`: medium collision / leaf-disk or
trunk-triangle hit / ground, ONE shared NEE occlusion sweep per bounce)
and Mueller bookkeeping mirrors the plane-parallel polarized tracer
(:mod:`eradiate_tpu.ops.tracer_polarized`: backward left-product P of
rotated Mueller matrices, scalar-pdf importance sampling).

Leaves are bilambertian — an unpolarized BSDF, hence an ideal
depolarizer: leaf NEE contributes ``P @ (f cos E, 0, 0, 0)`` (unpolarized
Stokes vectors are basis-invariant) and a leaf continuation collapses the
Mueller product to a depolarizer. Ground surfaces go through
:func:`eradiate_tpu.ops.bsdf_polarized.surface_mueller`, so polarized
floors (maignan, ocean_mishchenko) keep their full matrices. The
atmosphere's Rayleigh/tabulated-polarized phase matrices are the main
polarization source — exactly the regime the reference exercises.

The per-bounce uniform slot layout matches the scalar canopy tracer, so
scalar/polarized runs with one seed trace identical sample paths (the
cross-tracer consistency tests rely on it).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .fastrng import bounce_uniforms, derive_keys, origin_uniforms

from .bsdf_ops import (
    bilambertian_eval,
    bilambertian_sample_from_uniforms,
    bsdf_sample_from_uniforms,
)
from .bsdf_polarized import surface_mueller
from .canopy import LeafCloudArrays, leaf_nearest
from .medium import clamp_mu, take_1d, z_at_tau
from .mueller import default_basis, depolarizer, rotate_basis_angle, rotator
from .phase_ops import phase_sample_from_uniforms
from .scene_state import (
    IlluminationArrays,
    MediumArrays,
    SceneConfig,
    SensorArrays,
)
from .tracer_canopy import _canopy_helpers, _to_local, _to_world
from .tracer_polarized import _phase_mueller, _scatter_frames

__all__ = ["render_canopy_polarized"]

#: f32 Stokes/Mueller contractions run at full f32: a backend's default
#: matmul precision may round operands (TF32 on recent NVIDIA GPUs).
_HI = jax.lax.Precision.HIGHEST


def _make_bounce_canopy_polarized(
    config, medium_row, surface_row, leaf_row, leaves, illum_row,
    tris, tri_row, helpers, eps=1e-6,
):
    z_levels = medium_row.z_levels
    tau_levels = medium_row.tau_levels
    tau_top = tau_levels[-1]
    z_bottom = z_levels[0]
    z_top = z_levels[-1]
    tau_z = helpers["tau_z"]
    nee_dir = helpers["nee_dir"]
    nee_at = helpers["nee_at"]
    leaf_box = helpers["leaf_box"]
    tri_box = helpers["tri_box"]

    def bounce(depth_b, pos, d, P, b, beta, keys):
        B = pos.shape[0]
        # same slot layout as the scalar canopy tracer
        U = bounce_uniforms(config.rng, keys, depth_b, 8)
        u_dist = U[:, 0]
        u_sel, u_cos, u_phi = U[:, 1], U[:, 2:4], U[:, 4]
        u_srf = U[:, 5:7]
        u_rr = U[:, 7]

        z = pos[:, 2]
        mu = clamp_mu(d[:, 2])
        tau_here = tau_z(z)
        tau_exit = jnp.where(
            mu > 0.0, (tau_top - tau_here) / mu, tau_here / (-mu)
        )
        tau_s = -jnp.log1p(-u_dist)
        collide_med = tau_s < tau_exit

        tau_new = jnp.clip(tau_here + mu * tau_s, 0.0, tau_top)
        z_med, layer = z_at_tau(tau_new, z_levels, tau_levels)
        z_edge = jnp.where(mu > 0.0, z_top, z_bottom)
        t_med = jnp.where(collide_med, (z_med - z) / mu, (z_edge - z) / mu)

        t_leaf, n_leaf, hit_leaf = leaf_nearest(pos, d, t_med, leaves, leaf_box)
        if tris is not None:
            from .mesh import tri_nearest

            t_tri, n_tri, hit_tri = tri_nearest(pos, d, t_med, tris, tri_box)
            tri_first = hit_tri & (~hit_leaf | (t_tri < t_leaf))
            hit_scat = hit_leaf | hit_tri
            t_leaf = jnp.where(tri_first, t_tri, t_leaf)
            n_leaf = jnp.where(tri_first[:, None], n_tri, n_leaf)
        else:
            tri_first = jnp.zeros_like(hit_leaf)
            hit_scat = hit_leaf

        event_leaf = hit_scat
        event_med = collide_med & ~hit_scat
        event_ground = (
            (~collide_med) & ~hit_scat & (mu < 0.0) & config.has_surface
        )

        pos_leaf = pos + d * t_leaf[:, None]
        pos_med = pos + d * t_med[:, None]
        t_ground = (z_bottom - z) / mu
        pos_ground = pos + d * t_ground[:, None]
        pos_ground = pos_ground.at[:, 2].set(z_bottom)

        # ---- shared NEE (one occlusion sweep per bounce) ----------------
        to_front = -jnp.sign(jnp.sum(d * n_leaf, axis=-1))
        n_shade = n_leaf * to_front[:, None]
        w_nee_leaf_dir = nee_dir(pos_leaf)
        wi_leaf_sign = jnp.sign(
            jnp.sum(n_shade * w_nee_leaf_dir, axis=-1)
        )[:, None]
        # distance-scaled lift-off (see ops/tracer_canopy: f32 rounding
        # of pos + t d at TOA-scale t can land the hit below its own
        # surface; 2.4e-7 = 2 f32 ulp)
        eps_lane = (eps + t_leaf * 2.4e-7)[:, None]
        pos_leaf_off = pos_leaf + n_shade * wi_leaf_sign * eps_lane
        pos_ground_off = pos_ground + jnp.asarray([0.0, 0.0, eps])
        pos_nee = jnp.where(
            event_leaf[:, None],
            pos_leaf_off,
            jnp.where(event_med[:, None], pos_med, pos_ground_off),
        )
        w_nee, E_nee = nee_at(pos_nee)

        l_out = -d  # light leaves every vertex toward the sensor path

        # ---- medium collision (polarized phase) -------------------------
        albedo_col = take_1d(medium_row.albedo, layer)
        cos_nee = jnp.sum(w_nee * d, axis=-1)
        _, h_out_nee = _scatter_frames(-w_nee, l_out)
        M_nee = jax.vmap(
            lambda l, c: _phase_mueller(
                config.phase_kinds,
                medium_row.phase_params,
                medium_row.phase_weights,
                l,
                c,
            )
        )(layer, cos_nee)
        R_out = rotator(rotate_basis_angle(l_out, h_out_nee, b))
        S_in_med = jnp.zeros((B, 4)).at[:, 0].set(E_nee * albedo_col * beta)
        S_med = jnp.einsum(
            "bij,bjk,bkl,bl->bi", P, R_out, M_nee, S_in_med, precision=_HI
        )

        d_med = jax.vmap(
            lambda l, dd, us, uc, up: phase_sample_from_uniforms(
                config.phase_kinds,
                medium_row.phase_params,
                medium_row.phase_weights,
                l,
                dd,
                us,
                uc,
                up,
            )
        )(layer, d, u_sel, u_cos, u_phi)
        cos_scat = jnp.sum(d_med * d, axis=-1)
        from .phase_ops import phase_eval

        p_scalar = jax.vmap(
            lambda l, c: phase_eval(
                config.phase_kinds,
                medium_row.phase_params,
                medium_row.phase_weights,
                l,
                c,
            )
        )(layer, cos_scat)
        h_in_s, h_out_s = _scatter_frames(-d_med, l_out)
        M_s = jax.vmap(
            lambda l, c: _phase_mueller(
                config.phase_kinds,
                medium_row.phase_params,
                medium_row.phase_weights,
                l,
                c,
            )
        )(layer, cos_scat)
        M_full = jnp.einsum(
            "bij,bjk->bik", rotator(rotate_basis_angle(l_out, h_out_s, b)), M_s,
            precision=_HI,
        ) / jnp.maximum(p_scalar, 1e-30)[:, None, None]
        P_med = jnp.einsum("bij,bjk->bik", P, M_full, precision=_HI)
        b_med = h_in_s
        beta_med = beta * albedo_col

        # ---- leaf / trunk interaction (bilambertian = depolarizer) ------
        wo_leaf = _to_local(n_shade, -d)
        wi_sun_leaf = _to_local(n_shade, w_nee)
        if tris is not None:
            lp = {
                "reflectance": jnp.where(
                    tri_first, tri_row["reflectance"], leaf_row["reflectance"]
                ),
                "transmittance": jnp.where(
                    tri_first, tri_row["transmittance"],
                    leaf_row["transmittance"],
                ),
            }
        else:
            lp = {
                "reflectance": jnp.broadcast_to(leaf_row["reflectance"], (B,)),
                "transmittance": jnp.broadcast_to(
                    leaf_row["transmittance"], (B,)
                ),
            }
        f_leaf = bilambertian_eval(lp, wi_sun_leaf, wo_leaf)
        cos_sun_leaf = jnp.abs(jnp.sum(n_shade * w_nee, axis=-1))
        # unpolarized Stokes input is basis-invariant: no rotation needed
        S_in_leaf = jnp.zeros((B, 4)).at[:, 0].set(
            beta * f_leaf * cos_sun_leaf * E_nee
        )
        S_leaf = jnp.einsum("bij,bj->bi", P, S_in_leaf, precision=_HI)
        d_leaf_local, w_leaf = jax.vmap(
            lambda r, t, w, us, uc: bilambertian_sample_from_uniforms(
                {"reflectance": r, "transmittance": t}, w, us, uc
            )
        )(lp["reflectance"], lp["transmittance"], wo_leaf, u_sel, u_cos)
        d_leaf = _to_world(n_shade, d_leaf_local)
        # depolarizing continuation: polarization memory is destroyed. The
        # Mueller chain stays NORMALIZED (unit I-throughput) — the sampling
        # weight w_leaf lives in beta, as for phase (M/p_scalar) and
        # surface (M/f_scalar) continuations
        P_leaf = jnp.einsum(
            "bij,bjk->bik", P, depolarizer(jnp.ones_like(w_leaf)),
            precision=_HI,
        )
        b_leaf = default_basis(-d_leaf)
        beta_leaf = beta * w_leaf
        pos_leaf_new = pos_leaf + d_leaf * eps_lane

        # ---- ground (Mueller-general surface) ----------------------------
        wo = -d
        M_nee_srf = surface_mueller(
            config.surface_kind, surface_row.params, w_nee, wo,
            pos_ground[:, :2],
        )
        _, h_out_srf = _scatter_frames(-w_nee, wo)
        R_out_srf = rotator(rotate_basis_angle(wo, h_out_srf, b))
        mu_nee_g = jnp.maximum(w_nee[:, 2], 0.0)
        S_in_g = jnp.zeros((B, 4)).at[:, 0].set(beta * mu_nee_g * E_nee)
        S_ground = jnp.einsum(
            "bij,bjk,bkl,bl->bi", P, R_out_srf, M_nee_srf, S_in_g,
            precision=_HI,
        )

        d_ground, w_g = bsdf_sample_from_uniforms(
            config.surface_kind, surface_row.params, wo, u_srf,
            pos_ground[:, :2],
        )
        M_cont = surface_mueller(
            config.surface_kind, surface_row.params, d_ground, wo,
            pos_ground[:, :2],
        )
        h_in_c, h_out_c = _scatter_frames(-d_ground, wo)
        R_out_c = rotator(rotate_basis_angle(wo, h_out_c, b))
        f_scalar = jnp.maximum(M_cont[:, 0, 0], 1e-30)
        P_ground = jnp.einsum(
            "bij,bjk,bkl->bil", P, R_out_c, M_cont / f_scalar[:, None, None],
            precision=_HI,
        )
        b_ground = h_in_c
        beta_ground = beta * w_g

        # ---- combine ------------------------------------------------------
        S_add = jnp.where(
            event_leaf[:, None],
            S_leaf,
            jnp.where(
                event_med[:, None],
                S_med,
                jnp.where(event_ground[:, None], S_ground, 0.0),
            ),
        )
        pos2 = jnp.where(
            event_leaf[:, None], pos_leaf_new,
            jnp.where(event_med[:, None], pos_med, pos_ground),
        )
        d2 = jnp.where(
            event_leaf[:, None], d_leaf,
            jnp.where(event_med[:, None], d_med, d_ground),
        )
        P2 = jnp.where(
            event_leaf[:, None, None],
            P_leaf,
            jnp.where(
                event_med[:, None, None],
                P_med,
                jnp.where(event_ground[:, None, None], P_ground, P),
            ),
        )
        b2 = jnp.where(
            event_leaf[:, None], b_leaf,
            jnp.where(event_med[:, None], b_med, b_ground),
        )
        beta2 = jnp.where(
            event_leaf, beta_leaf,
            jnp.where(
                event_med, beta_med,
                jnp.where(event_ground, beta_ground, 0.0),
            ),
        )
        interacted = event_leaf | event_med | event_ground
        alive2 = interacted & (beta2 > 0.0)

        do_rr = depth_b >= config.rr_depth
        q = jnp.clip(beta2, 0.0, 0.95)
        survive = u_rr < q
        # RR reweighting applies ONCE, to beta: every contribution is
        # P @ ... @ S_in(beta ...), so scaling P as well would square the
        # 1/q factor (bias on RR-surviving deep paths)
        scale = jnp.where(do_rr & alive2 & survive, 1.0 / q, 1.0)
        beta2 = beta2 * scale
        alive2 = alive2 & jnp.where(do_rr, survive, True)

        return S_add, pos2, d2, P2, b2, beta2, alive2

    return bounce


def trace_paths_canopy_polarized_regen(
    config: SceneConfig,
    medium_row,
    surface_row,
    leaf_row,
    leaves: LeafCloudArrays,
    illum_row,
    init_pos,
    init_d,
    row_key,
    lane_first,
    quota,
    ext=None,
    tris=None,
    tri_row=None,
):
    """Regenerative polarized canopy trace. Returns ``(S_sum [B, 4],
    m2_sum [B])`` (m2 over the I component).

    Like the scalar loop (``tracer_canopy.trace_paths_canopy_regen``),
    lanes are periodically permuted by the Morton code of the current
    position (``CANOPY_SORT_EVERY``) so ray blocks stay spatially coherent
    (the Stokes state P/b travels with its lane; results are identical to
    the unsorted loop up to f32 summation grouping)."""
    from .tracer_canopy import _morton_u32, _sort_interval

    helpers = _canopy_helpers(
        config, medium_row, leaf_row, leaves, illum_row, tris, tri_row
    )
    bounce = _make_bounce_canopy_polarized(
        config, medium_row, surface_row, leaf_row, leaves, illum_row,
        tris, tri_row, helpers,
    )
    B = init_pos.shape[0]
    dtype = init_pos.dtype
    z_top = medium_row.z_levels[-1]
    row_keys_b = jnp.broadcast_to(row_key, (B,))
    b_init = default_basis(-init_d)
    eye4 = jnp.broadcast_to(jnp.eye(4, dtype=dtype), (B, 4, 4))
    sort_every = _sort_interval()
    box_lo, box_hi = helpers["leaf_box"]

    def sample_key(lane_first_l, s_local):
        return derive_keys(config.rng, row_keys_b, lane_first_l + s_local)

    def origin(keys, init_pos_l, ext_l):
        if ext is None:
            return init_pos_l
        u = origin_uniforms(config.rng, keys, 2, dtype=dtype)
        jit = (u - 0.5) * ext_l
        return init_pos_l + jnp.concatenate(
            [jit, jnp.zeros((B, 1), dtype)], axis=-1
        )

    def body(carry):
        (it, s_local, depth, pos, d, P, b, beta, S_cur, keys, done,
         S_sum, m2_sum, lane_first_l, quota_l, init_pos_l, init_d_l,
         b_init_l, ext_l, orig) = carry

        S_add, pos2, d2, P2, b2, beta2, alive2 = bounce(
            depth, pos, d, P, b, beta, keys
        )
        active = ~done
        S_cur = S_cur + jnp.where(active[:, None], S_add, 0.0)
        depth = depth + 1
        path_end = active & (~alive2 | (depth >= config.max_depth))

        S_sum = S_sum + jnp.where(path_end[:, None], S_cur, 0.0)
        m2_sum = m2_sum + jnp.where(path_end, S_cur[:, 0] ** 2, 0.0)
        s_local = s_local + path_end.astype(s_local.dtype)
        done = done | (s_local >= quota_l)

        regen = path_end & ~done
        keys_new = sample_key(lane_first_l, s_local)
        keys = jnp.where(regen, keys_new, keys)
        pos = jnp.where(
            regen[:, None], origin(keys_new, init_pos_l, ext_l), pos2
        )
        d = jnp.where(regen[:, None], init_d_l, d2)
        P = jnp.where(regen[:, None, None], eye4, P2)
        b = jnp.where(regen[:, None], b_init_l, b2)
        beta = jnp.where(regen, jnp.ones((), dtype), beta2)
        S_cur = jnp.where(path_end[:, None], 0.0, S_cur)
        depth = jnp.where(regen, 0, depth)

        # park done lanes at TOA pointing up (zero sweep-tile overlap)
        park = jnp.stack(
            [jnp.zeros(B, dtype), jnp.zeros(B, dtype),
             jnp.full(B, z_top, dtype)], axis=-1
        )
        up = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], dtype), (B, 3))
        pos = jnp.where(done[:, None], park, pos)
        d = jnp.where(done[:, None], up, d)

        state = (s_local, depth, pos, d, P, b, beta, S_cur, keys, done,
                 S_sum, m2_sum, lane_first_l, quota_l, init_pos_l,
                 init_d_l, b_init_l, ext_l, orig)
        if sort_every > 0:
            def do_sort(st):
                code = _morton_u32(st[2], box_lo, box_hi)
                code = jnp.where(st[9], jnp.uint32(0xFFFFFFFF), code)
                order = jnp.argsort(code)
                return jax.tree.map(lambda x: x[order], st)

            state = jax.lax.cond(
                it % sort_every == sort_every - 1,
                do_sort,
                lambda st: st,
                state,
            )

        return (it + 1,) + state

    def cond(carry):
        return jnp.any(~carry[10])

    lane_ext = (
        jnp.zeros((B, 2), dtype) if ext is None else jnp.asarray(ext)
    )
    lane_first_arr = jnp.asarray(lane_first)
    keys0 = sample_key(lane_first_arr, jnp.zeros(B, jnp.int32))
    init = (
        jnp.asarray(0),
        jnp.zeros(B, jnp.int32),
        jnp.zeros(B, jnp.int32),
        origin(keys0, init_pos, lane_ext if ext is not None else None),
        init_d,
        eye4,
        b_init,
        jnp.ones(B, dtype),
        jnp.zeros((B, 4), dtype),
        keys0,
        jnp.zeros(B, dtype=bool),
        jnp.zeros((B, 4), dtype),
        jnp.zeros(B, dtype),
        lane_first_arr,
        jnp.broadcast_to(jnp.asarray(quota), (B,)),
        init_pos,
        init_d,
        b_init,
        lane_ext,
        jnp.arange(B, dtype=jnp.int32),
    )
    final = jax.lax.while_loop(cond, body, init)
    S_sum, m2_sum, orig = final[11], final[12], final[19]
    # undo the in-loop permutations
    S_out = jnp.zeros((B, 4), dtype).at[orig].set(S_sum)
    m2_out = jnp.zeros(B, dtype).at[orig].set(m2_sum)
    return S_out, m2_out


def _render_row_canopy_polarized(
    config, n_pix, spp, medium_row, surface_row, leaf_row, leaves, illum_row,
    directions, target, ray_offset, key, tris=None, tri_row=None,
    target_extent=None, sample_offset=None, spp_stride=None,
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
    t_up = jnp.where(
        jnp.isnan(ray_offset),
        (z_top - tgt[:, 2]) / jnp.maximum(w_v[:, 2], 1e-6),
        ray_offset,
    )
    init_pos = tgt + w_v * t_up[:, None]
    init_d = -w_v
    S_sum, m2_sum = trace_paths_canopy_polarized_regen(
        config, medium_row, surface_row, leaf_row, leaves, illum_row,
        init_pos, init_d, key, lane_first, quota, ext=ext,
        tris=tris, tri_row=tri_row,
    )
    stokes = jnp.sum(S_sum.reshape(n_pix, lp, 4), axis=1) / spp
    m2 = jnp.sum(m2_sum.reshape(n_pix, lp), axis=1) / spp
    return stokes, m2


def render_batch_canopy_polarized_impl(
    config, n_pix, spp, medium, surface, leaf_params, leaves, illum,
    directions, target, ray_offset, keys, tris=None, tri_params=None,
    target_extent=None, sample_offset=None, spp_stride=None,
):
    # lax.map, not vmap (see ops/tracer.render_batch_impl)
    z_levels = medium.z_levels

    def one_row(args):
        mr_part, sr, lr, irr, sky, pos, k, tr = args
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
            position=pos,
        )
        return _render_row_canopy_polarized(
            config, n_pix, spp, mr, sr, lr, leaves, ir, directions, target,
            ray_offset, k, tris, tr, target_extent=target_extent,
            sample_offset=sample_offset, spp_stride=spp_stride,
        )

    med_part = (
        medium.tau_levels,
        medium.albedo,
        medium.phase_weights,
        medium.phase_params,
    )
    S = keys.shape[0]
    pos_rows = (
        None
        if illum.position is None
        else jnp.broadcast_to(illum.position, (S, 3))
    )
    tri_rows = None if tris is None else tri_params
    return jax.lax.map(
        one_row,
        (
            med_part,
            surface,
            leaf_params,
            illum.irradiance,
            illum.sky_radiance,
            pos_rows,
            keys,
            tri_rows,
        ),
    )


_render_batch_canopy_polarized = jax.jit(
    render_batch_canopy_polarized_impl, static_argnums=(0, 1, 2)
)


def render_canopy_polarized(
    scene,
    leaf_params,
    leaves: LeafCloudArrays,
    sensor: SensorArrays,
    config: SceneConfig,
    spp: int,
    seed: int = 0,
    spp_chunk: int | None = None,
    tris=None,
    tri_params=None,
):
    """Polarized canopy render: returns ``stokes`` [S, N, 4]
    (meridian-aligned), ``radiance`` (= I), ``m2`` of I, ``spp``."""
    from .tracer import MAX_PATHS_PER_DISPATCH

    directions = jnp.asarray(sensor.directions)
    target = jnp.asarray(sensor.target)
    ray_offset = jnp.asarray(sensor.ray_offset)
    n_pix = directions.shape[0]
    S = scene.medium.tau_levels.shape[0]

    if spp_chunk is None:
        max_spp = max(1, (MAX_PATHS_PER_DISPATCH // 8) // max(S * n_pix, 1))
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

    st_sum = jnp.zeros((S, n_pix, 4))
    m2_sum = jnp.zeros((S, n_pix))
    traced = 0
    for chunk_id, n in enumerate(chunks):
        chunk_keys = jax.vmap(jax.random.fold_in)(
            row_keys, jnp.full(S, chunk_id)
        )
        st, m2 = _render_batch_canopy_polarized(
            config, n_pix, n, scene.medium, scene.surface, leaf_params,
            leaves, scene.illumination, directions, target, ray_offset,
            chunk_keys, tris, tri_params,
            None
            if sensor.target_extent is None
            else jnp.asarray(sensor.target_extent),
        )
        st_sum = st_sum + st * n
        m2_sum = m2_sum + m2 * n
        traced += n

    stokes = st_sum / traced
    return {
        "stokes": stokes,
        "radiance": stokes[..., 0],
        "m2": m2_sum / traced,
        "spp": traced,
    }
