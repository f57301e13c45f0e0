"""Wavefront path tracer — polarized transport, spherical-shell geometry.

Combines the exact-flight shell traversal of
:mod:`eradiate_tpu.ops.tracer_spherical` with the Mueller/Stokes calculus
of :mod:`eradiate_tpu.ops.tracer_polarized` (reference: polarized Mitsuba
variants rendering ``sphericalcoordsvolume`` media, SURVEY §2.1). Null
collisions leave the accumulated Mueller product untouched; accepted
collisions apply frame-rotated phase matrices; surfaces use the
Mueller-general dispatch (scalar kinds reduce to depolarizers exactly).

Output Stokes vectors are referenced to the meridian basis of each viewing
direction (the reference ``stokes`` integrator's ``meridian_align``
extension, ``scenes/integrators/_core.py:80-92``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .fastrng import bounce_uniforms, derive_keys, origin_uniforms

from .bsdf_ops import bsdf_sample_from_uniforms
from .bsdf_polarized import surface_mueller
from .mueller import default_basis, rotate_basis_angle, rotator
from .phase_ops import phase_eval, phase_sample_from_uniforms
from .scene_state import (
    IlluminationArrays,
    SensorArrays,
    SurfaceArrays,
    SceneConfig,
)
from .spherical import ray_sphere_intersect, shell_event
from .tracer_polarized import _phase_mueller, _scatter_frames
from .tracer_spherical import (
    SphericalMediumArrays,
    _to_local,
    _to_world,
    spherical_lanes_target,
)

__all__ = ["render_spherical_polarized"]

#: f32 Stokes/Mueller contractions run at full f32: a backend's default
#: matmul precision may round operands (TF32 on recent NVIDIA GPUs).
_HI = jax.lax.Precision.HIGHEST


def _make_event_polarized(config: SceneConfig, medium_row, surface_row, illum_row):
    """Per-tentative-event Mueller-transport closure shared by the
    one-shot and regenerative loops (see ops/tracer._make_bounce)."""
    radii = medium_row.radii
    r_ground = radii[0]
    r_top = radii[-1]

    d_sun = illum_row.direction
    w_sun = -d_sun
    E_sun = illum_row.irradiance

    eps_t = 1e-4

    def event(evt_b, p, d, P, b, beta, depth, keys):
        B = p.shape[0]
        # one batched threefry draw per event, same slot layout as the
        # scalar spherical tracer (ops/tracer_spherical._make_event)
        U = bounce_uniforms(config.rng, keys, evt_b, 8)
        u_dist = U[:, 0]
        u_ph_sel, u_ph_cos, u_ph_phi = U[:, 1], U[:, 2:4], U[:, 4]
        u_srf = U[:, 5:7]
        u_rr = U[:, 7]

        tgn, tgf, hit_g = ray_sphere_intersect(p, d, r_ground)
        t_ground = jnp.where(
            hit_g & (tgn > eps_t),
            tgn,
            jnp.where(
                hit_g
                & (tgf > eps_t)
                & (tgn <= eps_t)
                & (jnp.sum(p * p, -1) < r_ground**2),
                tgf,
                jnp.inf,
            ),
        )
        _, ttf, _ = ray_sphere_intersect(p, d, r_top)
        t_exit = jnp.maximum(ttf, eps_t)
        t_max = jnp.minimum(t_ground, t_exit)

        # exact free flight with the event-point sun slant tau
        # (ops/spherical.shell_event). With a precomputed sun-tau table on
        # the medium, NEE transmittance fetches from it instead (two-hot
        # matmul bilinear;
        # see SphericalMediumArrays.sun_tau for cost/accuracy numbers).
        tau_s = -jnp.log1p(-u_dist)
        _lr = bool(getattr(config, "lr_flight", False))
        if _lr:
            # likelihood-ratio flight (sensitivity path, XLA-only):
            # sample from the detached medium, restore parameter
            # dependence via primal-neutral importance weights —
            # unbiased extinction tangents (see ops/tracer.py and the
            # scalar spherical twin, ops/tracer_spherical._make_event).
            # Slant NEE tau stays attached (smooth at the fixed event
            # point); the table path is never taken here.
            from .spherical import shell_flight_lr, slant_tau_exact

            sg = jax.lax.stop_gradient
            accept, t_col, layer, g_col, tau_max_att = shell_flight_lr(
                p, d, t_max, radii, medium_row.sigma_t, tau_s
            )
            r_col = jnp.exp(g_col - sg(g_col))  # primal exactly 1.0
            r_bnd = jnp.exp(-(tau_max_att - sg(tau_max_att)))  # primal 1.0
            t_step = jnp.where(accept, t_col, t_max)
            p_new = p + d * t_step[:, None]
            tau_sun = slant_tau_exact(p_new, w_sun, radii, medium_row.sigma_t)
        elif medium_row.sun_tau is not None:
            from .spherical import TAU_BLOCKED, shell_flight, sun_tau_fetch

            accept, t_col, layer = shell_flight(
                p, d, t_max, radii, medium_row.sigma_t, tau_s
            )
            r_col = r_bnd = 1.0
            t_step = jnp.where(accept, t_col, t_max)
            p_new = p + d * t_step[:, None]
            r_ev = jnp.sqrt(jnp.sum(p_new * p_new, axis=-1))
            mu_ev = jnp.sum(p_new * w_sun, axis=-1) / jnp.maximum(
                r_ev, 1e-12
            )
            b2w = jnp.sum(
                jnp.cross(p_new, jnp.broadcast_to(w_sun, p_new.shape)) ** 2,
                axis=-1,
            )
            blocked = (mu_ev < 0.0) & (b2w <= r_ground * r_ground)
            if medium_row.sun_r_grid is not None:
                from .spherical import sun_tau_fetch_fast

                tau_fetch = sun_tau_fetch_fast(
                    medium_row.sun_tau, medium_row.sun_r_grid,
                    medium_row.sun_mu_warp, r_ev, mu_ev,
                )
            else:
                tau_fetch = sun_tau_fetch(
                    medium_row.sun_tau, radii, medium_row.mu_grid,
                    r_ev, mu_ev,
                )
            tau_sun = jnp.where(blocked, TAU_BLOCKED, tau_fetch)
        else:
            accept, t_col, layer, tau_sun = shell_event(
                p, d, t_max, radii, medium_row.sigma_t, tau_s, w_sun
            )
            r_col = r_bnd = 1.0
            t_step = jnp.where(accept, t_col, t_max)
            p_new = p + d * t_step[:, None]

        hit_surface = (~accept) & (t_ground <= t_exit) & config.has_surface

        r_new = jnp.linalg.norm(p_new, axis=-1)
        from .medium import take_1d

        albedo_col = take_1d(medium_row.albedo, layer)
        l_out = -d

        # ---- NEE at accepted collisions --------------------------------
        cos_nee = jnp.sum(d_sun * l_out, axis=-1)
        _, h_out_nee = _scatter_frames(jnp.broadcast_to(d_sun, d.shape), l_out)
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
        # ONE slant-tau evaluation (from the fused event kernel) serves
        # both NEE branches
        T_sun = jnp.exp(-jnp.minimum(tau_sun, 80.0))
        S_sun = jnp.zeros((B, 4)).at[:, 0].set(
            E_sun * T_sun * albedo_col * beta * r_col
        )
        S_col = jnp.einsum(
            "bij,bjk,bkl,bl->bi", P, R_out, M_nee, S_sun, precision=_HI
        )

        # ---- sampled continuation at accepted collisions ---------------
        d_new = jax.vmap(
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
        )(layer, d, u_ph_sel, u_ph_cos, u_ph_phi)
        l_in_new = -d_new
        cos_scat = jnp.sum(d_new * d, axis=-1)
        p_scalar = jax.vmap(
            lambda l, c: phase_eval(
                config.phase_kinds,
                medium_row.phase_params,
                medium_row.phase_weights,
                l,
                c,
            )
        )(layer, cos_scat)
        h_in_s, h_out_s = _scatter_frames(l_in_new, l_out)
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
        P_col = jnp.einsum("bij,bjk->bik", P, M_full, precision=_HI)
        b_col = h_in_s
        beta_col = beta * albedo_col * r_col

        # ---- surface interaction (Mueller-general) ---------------------
        n_srf = p_new / jnp.maximum(r_new[:, None], 1e-12)
        wo_local = _to_local(n_srf, l_out)
        wi_sun_local = _to_local(n_srf, jnp.broadcast_to(w_sun, p_new.shape))
        M_srf = surface_mueller(
            config.surface_kind, surface_row.params, wi_sun_local, wo_local, None
        )
        _, h_out_srf = _scatter_frames(jnp.broadcast_to(d_sun, d.shape), l_out)
        R_out_srf = rotator(rotate_basis_angle(l_out, h_out_srf, b))
        mu_sun_srf = jnp.maximum(jnp.sum(n_srf * w_sun, axis=-1), 0.0)
        S_sun_srf = jnp.zeros((B, 4)).at[:, 0].set(
            beta * r_bnd * mu_sun_srf * T_sun * E_sun
        )
        S_srf = jnp.einsum(
            "bij,bjk,bkl,bl->bi", P, R_out_srf, M_srf, S_sun_srf,
            precision=_HI,
        )

        d_srf_local, w_srf = bsdf_sample_from_uniforms(
            config.surface_kind, surface_row.params, wo_local, u_srf
        )
        d_srf = _to_world(n_srf, d_srf_local)
        M_cont = surface_mueller(
            config.surface_kind, surface_row.params, d_srf_local, wo_local, None
        )
        h_in_c, h_out_c = _scatter_frames(-d_srf, l_out)
        R_out_c = rotator(rotate_basis_angle(l_out, h_out_c, b))
        f_scalar = jnp.maximum(M_cont[:, 0, 0], 1e-30)
        P_srf = jnp.einsum(
            "bij,bjk,bkl->bil", P, R_out_c, M_cont / f_scalar[:, None, None],
            precision=_HI,
        )
        b_srf = h_in_c
        beta_srf = beta * r_bnd * w_srf
        p_srf = p_new + n_srf * eps_t

        # ---- combine ----------------------------------------------------
        S_add = jnp.where(
            accept[:, None],
            S_col,
            jnp.where(hit_surface[:, None], S_srf, 0.0),
        )
        p2 = jnp.where(hit_surface[:, None], p_srf, p_new)
        d2 = jnp.where(
            accept[:, None], d_new, jnp.where(hit_surface[:, None], d_srf, d)
        )
        P2 = jnp.where(
            accept[:, None, None],
            P_col,
            jnp.where(hit_surface[:, None, None], P_srf, P),
        )
        b2 = jnp.where(
            accept[:, None], b_col, jnp.where(hit_surface[:, None], b_srf, b)
        )
        beta2 = jnp.where(
            accept, beta_col, jnp.where(hit_surface, beta_srf, beta)
        )
        interacted = accept | hit_surface
        escaped = ~accept & ~hit_surface
        alive2 = ~escaped & (beta2 > 0.0)
        depth2 = depth + jnp.where(interacted & alive2, 1, 0)

        do_rr = interacted & (depth2 >= config.rr_depth)
        q = jnp.clip(beta2, 0.0, 0.95)
        survive = u_rr < q
        # RR reweighting applies ONCE, to beta: every contribution is
        # P @ ... @ S_in(beta ...), so scaling P as well would square the
        # 1/q factor (bias on RR-surviving deep paths)
        scale = jnp.where(do_rr & alive2 & survive, 1.0 / q, 1.0)
        beta2 = beta2 * scale
        alive2 = alive2 & jnp.where(do_rr, survive, True)
        alive2 = alive2 & (depth2 < config.max_depth)

        return S_add, p2, d2, P2, b2, beta2, depth2, alive2

    return event


def trace_paths_spherical_polarized(
    config: SceneConfig,
    medium_row,
    surface_row,
    illum_row,
    init_p,
    init_d,
    keys,
    max_iterations: int,
):
    """One-shot loop: per-path Stokes estimates [B, 4] in the meridian
    basis of the initial viewing direction (reference implementation)."""
    B = init_p.shape[0]
    event = _make_event_polarized(config, medium_row, surface_row, illum_row)
    b_init = default_basis(-init_d)
    P_init = jnp.broadcast_to(jnp.eye(4), (B, 4, 4))

    def body(carry):
        it, p, d, P, b, beta, S_acc, alive, depth, keys = carry
        S_add, p2, d2, P2, b2, beta2, depth2, alive2 = event(
            jnp.full(B, it), p, d, P, b, beta, depth, keys
        )
        S_acc = S_acc + jnp.where(alive[:, None], S_add, 0.0)
        alive = alive & alive2
        return (it + 1, p2, d2, P2, b2, beta2, S_acc, alive, depth2, keys)

    def cond(carry):
        return (carry[0] < max_iterations) & jnp.any(carry[7])

    init = (
        jnp.asarray(0),
        init_p,
        init_d,
        P_init,
        b_init,
        jnp.ones(B, init_p.dtype),
        jnp.zeros((B, 4), init_p.dtype),
        jnp.ones(B, dtype=bool),
        jnp.zeros(B, dtype=jnp.int32),
        keys,
    )
    final = jax.lax.while_loop(cond, body, init)
    return final[6]


def trace_paths_spherical_polarized_regen(
    config: SceneConfig,
    medium_row,
    surface_row,
    illum_row,
    init_p,
    init_d,
    row_key,
    lane_first,
    quota,
    max_iterations: int,
):
    """Regenerative polarized shell trace (see
    ops/tracer.trace_paths_regen). Returns (S_sum [B, 4], m2_sum [B])."""
    B = init_p.shape[0]
    dtype = init_p.dtype
    event = _make_event_polarized(config, medium_row, surface_row, illum_row)
    b_init = default_basis(-init_d)
    eye4 = jnp.broadcast_to(jnp.eye(4, dtype=dtype), (B, 4, 4))
    row_keys_b = jnp.broadcast_to(row_key, (B,))

    def sample_key(s_local):
        return derive_keys(config.rng, row_keys_b, lane_first + s_local)

    def body(carry):
        (s_local, evt, depth, p, d, P, b, beta, S_cur, keys, done,
         S_sum, m2_sum) = carry

        S_add, p2, d2, P2, b2, beta2, depth2, alive2 = event(
            evt, p, d, P, b, beta, depth, keys
        )
        active = ~done
        S_cur = S_cur + jnp.where(active[:, None], S_add, 0.0)
        evt = evt + 1
        path_end = active & (~alive2 | (evt >= max_iterations))

        S_sum = S_sum + jnp.where(path_end[:, None], S_cur, 0.0)
        m2_sum = m2_sum + jnp.where(path_end, S_cur[:, 0] ** 2, 0.0)
        s_local = s_local + path_end.astype(s_local.dtype)
        done = done | (s_local >= quota)

        regen = path_end & ~done
        keys = jnp.where(regen, sample_key(s_local), keys)
        p = jnp.where(regen[:, None], init_p, p2)
        d = jnp.where(regen[:, None], init_d, d2)
        P = jnp.where(regen[:, None, None], eye4, P2)
        b = jnp.where(regen[:, None], b_init, b2)
        beta = jnp.where(regen, jnp.ones((), dtype), beta2)
        depth = jnp.where(regen, 0, depth2)
        evt = jnp.where(regen, 0, evt)
        S_cur = jnp.where(path_end[:, None], 0.0, S_cur)

        return (s_local, evt, depth, p, d, P, b, beta, S_cur, keys, done,
                S_sum, m2_sum)

    def cond(carry):
        return jnp.any(~carry[10])

    init = (
        jnp.zeros(B, jnp.int32),
        jnp.zeros(B, jnp.int32),
        jnp.zeros(B, jnp.int32),
        init_p,
        init_d,
        eye4,
        b_init,
        jnp.ones(B, dtype),
        jnp.zeros((B, 4), dtype),
        sample_key(jnp.zeros(B, jnp.int32)),
        jnp.zeros(B, dtype=bool),
        jnp.zeros((B, 4), dtype),
        jnp.zeros(B, dtype),
    )
    final = jax.lax.while_loop(cond, body, init)
    return final[11], final[12]


def _render_row(
    config, n_pix, spp, max_iterations, medium_row, surface_row, illum_row,
    directions, target, key, sample_offset=None, spp_stride=None,
):
    from .tracer import lane_partition

    lp, pix, slot, lane_first, quota = lane_partition(
        n_pix, spp, lanes_target=spherical_lanes_target(n_pix, spp),
        spp_stride=spp_stride, sample_offset=sample_offset,
    )
    B = n_pix * lp
    r_top = medium_row.radii[-1]
    w_v = directions[pix]
    _, t_far, _ = ray_sphere_intersect(
        jnp.broadcast_to(target, (B, 3)), w_v, r_top
    )
    init_p = target[None, :] + w_v * t_far[:, None]
    init_d = -w_v
    S_sum, m2_sum = trace_paths_spherical_polarized_regen(
        config, medium_row, surface_row, illum_row, init_p, init_d, key,
        lane_first, quota, max_iterations,
    )
    stokes = jnp.sum(S_sum.reshape(n_pix, lp, 4), axis=1) / spp
    m2 = jnp.sum(m2_sum.reshape(n_pix, lp), axis=1) / spp
    return stokes, m2


def render_batch_impl(
    config, n_pix, spp, max_iterations, medium, surface, illum, directions,
    target, keys, sample_offset=None, spp_stride=None,
):
    # lax.map, not vmap: vmapping the while_loop defeats XLA's fusion of
    # the masked table lookups (see ops/tracer.render_batch_impl)
    radii = medium.radii

    def one_row(args):
        mr_part, sr, irr, sky, k = args
        mr = SphericalMediumArrays(
            radii=radii,
            sigma_t=mr_part[0],
            sigma_majorant=mr_part[1],
            albedo=mr_part[2],
            phase_weights=mr_part[3],
            phase_params=mr_part[4],
            sun_tau=mr_part[5] if len(mr_part) > 5 else None,
            mu_grid=medium.mu_grid,
            sun_r_grid=medium.sun_r_grid,
            sun_mu_warp=medium.sun_mu_warp,
        )
        ir = IlluminationArrays(
            direction=illum.direction,
            irradiance=irr,
            cos_cutoff=illum.cos_cutoff,
            sky_radiance=sky,
        )
        return _render_row(
            config, n_pix, spp, max_iterations, mr, sr, ir, directions,
            target, k, sample_offset=sample_offset, spp_stride=spp_stride,
        )

    med_part = (
        medium.sigma_t,
        medium.sigma_majorant,
        medium.albedo,
        medium.phase_weights,
        medium.phase_params,
    )
    if medium.sun_tau is not None:
        med_part = med_part + (medium.sun_tau,)
    return jax.lax.map(
        one_row, (med_part, surface, illum.irradiance, illum.sky_radiance, keys)
    )


_render_batch = jax.jit(render_batch_impl, static_argnums=(0, 1, 2, 3))


def render_spherical_polarized(
    scene_medium: SphericalMediumArrays,
    surface: SurfaceArrays,
    illum: IlluminationArrays,
    sensor: SensorArrays,
    config: SceneConfig,
    spp: int,
    seed: int = 0,
    max_iterations: int = 512,
    spp_chunk: int | None = None,
):
    """Polarized spherical-shell render: ``stokes`` [S, N, 4]
    (meridian-aligned), ``radiance`` = I, ``m2`` of I, ``spp``."""
    from .tracer import MAX_PATHS_PER_DISPATCH

    directions = jnp.asarray(sensor.directions)
    target = jnp.asarray(sensor.target)
    n_pix = directions.shape[0]
    S = scene_medium.sigma_t.shape[0]

    if spp_chunk is None:
        max_spp = max(1, MAX_PATHS_PER_DISPATCH // max(S * n_pix, 1))
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
        chunk_keys = jax.vmap(jax.random.fold_in)(row_keys, jnp.full(S, chunk_id))
        st, m2 = _render_batch(
            config, n_pix, n, max_iterations, scene_medium, surface, illum,
            directions, target, chunk_keys,
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
