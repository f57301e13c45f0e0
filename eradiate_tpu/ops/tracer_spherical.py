"""Wavefront path tracer — spherical-shell geometry.

Curved-shell counterpart of :mod:`eradiate_tpu.ops.tracer` (BASELINE
config 4; reference: ``sphericalcoordsvolume`` + ``heterogeneous`` medium,
SURVEY §2.1). Free flight is **exact**: the cumulative optical depth along
a straight ray through piecewise-constant shells is closed-form, so
collisions invert it directly (:func:`eradiate_tpu.ops.spherical.
shell_flight`) — no null-collision/majorant loop, zero tracking variance
(the deterministic-transmittance quality the reference's ``piecewise``
medium has in plane-parallel geometry, extended to shells). Next-event
estimation likewise computes the sun slant optical depth in closed form
per event (:func:`eradiate_tpu.ops.spherical.slant_tau_exact`).

Every while-loop iteration is a real scatter/surface event; the loop is
bounded by ``config.max_depth``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp

from .fastrng import bounce_uniforms, derive_keys, origin_uniforms

from .bsdf_ops import bsdf_eval, bsdf_sample_from_uniforms
from .medium import fetch_at_index
from .phase_ops import (
    layer_param_slots,
    ortho_frame,
    phase_eval_at,
    phase_sample_at,
    rebuild_fetched,
)
from .scene_state import SensorArrays, SurfaceArrays, IlluminationArrays, SceneConfig, _pytree_dataclass
from .spherical import ray_sphere_intersect, shell_event

__all__ = ["SphericalMediumArrays", "render_spherical"]


#: Lane-count target for the spherical regenerative tracers: a deep
#: regeneration quota (tail amortization) matters more than a wide lane
#: pool, so the default pool is 2^14 lanes.
SPHERICAL_LANES_TARGET = 2**14

#: A wider pool lowers the per-lane bounce cost, but only pays while
#: regeneration quotas stay deep, so the adaptive target takes it only
#: when the sample budget sustains quota >= ~24 at 64k lanes. Both sizes
#: were tuned on the previous accelerator; a GPU sweep is an open item
#: (ROADMAP, Speed).
_LANES_HI = 2**16
_QUOTA_DEEP = 24


def spherical_lanes_target(n_pix: int, spp: int) -> int:
    if n_pix * spp >= _LANES_HI * _QUOTA_DEEP:
        return _LANES_HI
    return SPHERICAL_LANES_TARGET


@_pytree_dataclass
class SphericalMediumArrays:
    """Radially-stratified medium, spectrally batched."""

    radii: Any  # [L+1] shell boundary radii (ascending, from planet center)
    sigma_t: Any  # [S, L]
    sigma_majorant: Any  # [S]
    albedo: Any  # [S, L]
    phase_weights: Any  # [S, C, L]
    phase_params: Any
    #: optional precomputed sun slant-tau table [S, L+1, M] over
    #: (level radius, local sun cosine), built WITHOUT ground blockage
    #: (``sun_tau_table(..., r_ground=0)``) — the tracer applies the
    #: exact cross-product blocked test and fetches via the two-hot matmul
    #: bilinear (:func:`eradiate_tpu.ops.spherical.sun_tau_fetch`).
    #: When present, NEE transmittance uses the table instead of the
    #: exact per-event slant recomputation: the round-5 ablation measured
    #: the exact slant at 47% of the c4 per-event cost (0.72 of 1.53 ms
    #: per loop iteration at 64k lanes) vs 0.27 ms for the fetch, with
    #: max 7.6e-4 relative radiance error on BASELINE c4 (SZA 75). None
    #: keeps the exact path (f64 modes, sensitivity renders).
    sun_tau: Any = None
    mu_grid: Any = None
    #: round-5 fast-fetch table axes (:func:`eradiate_tpu.ops.spherical.
    #: sun_tau_fetch_fast`): a UNIFORM radius grid [Nr] and the asinh
    #: mu-warp constants (mu_c, s, a, b) — cell location is arithmetic,
    #: removing the [B, Nr]/[B, M] compare-sum index reductions the c4
    #: xprof breakdown put at ~13% of device time. When ``sun_r_grid``
    #: is None the legacy shell-level/piecewise-grid fetch
    #: (:func:`~eradiate_tpu.ops.spherical.sun_tau_fetch`) is used.
    sun_r_grid: Any = None
    sun_mu_warp: Any = None


def _to_local(n, v):
    """World vector -> local frame with +z = n."""
    t1, t2 = ortho_frame(n)
    return jnp.stack(
        [
            jnp.sum(t1 * v, axis=-1),
            jnp.sum(t2 * v, axis=-1),
            jnp.sum(n * v, axis=-1),
        ],
        axis=-1,
    )


def _to_world(n, v):
    t1, t2 = ortho_frame(n)
    return (
        t1 * v[..., 0:1] + t2 * v[..., 1:2] + n * v[..., 2:3]
    )


def _make_event(config: SceneConfig, medium_row, surface_row, illum_row):
    """Per-event transition closure (exact shell free flight) shared by
    the one-shot and regenerative loops; see
    :func:`eradiate_tpu.ops.tracer._make_bounce` for the pattern."""
    radii = medium_row.radii
    r_ground = radii[0]
    r_top = radii[-1]

    d_sun = illum_row.direction
    w_sun = -d_sun
    E_sun = illum_row.irradiance

    eps_t = 1e-4  # km; surface offset to avoid self-intersection

    def event(evt_b, p, d, beta, depth, keys):
        # one batched threefry draw per event (see ops/tracer._make_bounce)
        U = bounce_uniforms(config.rng, keys, evt_b, 8)
        u_dist = U[:, 0]
        u_ph_sel, u_ph_cos, u_ph_phi = U[:, 1], U[:, 2:4], U[:, 4]
        u_srf = U[:, 5:7]
        u_rr = U[:, 7]

        # distance to boundaries
        tgn, tgf, hit_g = ray_sphere_intersect(p, d, r_ground)
        t_ground = jnp.where(
            hit_g & (tgn > eps_t),
            tgn,
            jnp.where(hit_g & (tgf > eps_t) & (tgn <= eps_t) & (jnp.sum(p * p, -1) < r_ground**2), tgf, jnp.inf),
        )
        _, ttf, _ = ray_sphere_intersect(p, d, r_top)
        t_exit = jnp.maximum(ttf, eps_t)
        t_max = jnp.minimum(t_ground, t_exit)

        # ---- exact free flight + event-point sun tau (ONE launch) ------
        # closed-form inversion of the piecewise cumulative tau along the
        # ray — every event is a REAL collision; no null-collision loop,
        # deterministic transmittance — fused with the NEE slant depth at
        # the event point (ops/spherical.shell_event): in-loop [B, W]
        # kernels are launch-bound once the shell merge shrinks W, so one
        # fused launch per event beats flight + slant separately
        tau_s = -jnp.log1p(-u_dist)
        _lr = bool(getattr(config, "lr_flight", False))
        if _lr:
            # likelihood-ratio flight (sensitivity path, XLA-only): sample
            # from the detached medium, restore parameter dependence via
            # primal-neutral importance weights — unbiased extinction
            # tangents (see ops/tracer.py). Slant NEE tau stays attached
            # (smooth at the fixed event point).
            from .spherical import shell_flight_lr, slant_tau_exact

            sg = jax.lax.stop_gradient
            accept, t_col, layer, g_col, tau_max_att = shell_flight_lr(
                p, d, t_max, radii, medium_row.sigma_t, tau_s
            )
            r_col = jnp.exp(g_col - sg(g_col))  # primal exactly 1.0
            r_bnd = jnp.exp(-(tau_max_att - sg(tau_max_att)))  # primal 1.0
            t_step = jnp.where(accept, t_col, t_max)
            p_new = p + d * t_step[:, None]
            tau_sun = slant_tau_exact(
                p_new, w_sun, radii, medium_row.sigma_t
            )
        elif medium_row.sun_tau is not None:
            # table NEE: exact flight, then the sun slant tau from the
            # precomputed (radius, local cosine) table — two-hot matmul
            # bilinear fetch, no [B, L] slant recomputation per event
            # (see SphericalMediumArrays.sun_tau for the measured cost/
            # accuracy trade). Ground blockage stays exact (the table is
            # built with r_ground = 0).
            from .spherical import (
                TAU_BLOCKED,
                shell_flight,
                sun_tau_fetch,
                sun_tau_fetch_fast,
            )

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
                tau_fetch = sun_tau_fetch_fast(
                    medium_row.sun_tau, medium_row.sun_r_grid,
                    medium_row.sun_mu_warp, r_ev, mu_ev,
                )
            else:
                tau_fetch = sun_tau_fetch(
                    medium_row.sun_tau, radii, medium_row.mu_grid, r_ev, mu_ev
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

        # ONE fused one-hot fetch for all per-layer data (albedo, blend
        # weights, layer-indexed phase params) — see ops/medium.fetch_at_index
        C = len(config.phase_kinds)
        param_tables, param_slots = layer_param_slots(
            config.phase_kinds, medium_row.phase_params
        )
        fetched = fetch_at_index(
            layer,
            [medium_row.albedo]
            + [medium_row.phase_weights[c] for c in range(C)]
            + param_tables,
        )
        albedo_col = fetched[0]
        weights_at = jnp.stack(fetched[1 : 1 + C], axis=-1)
        params_at = rebuild_fetched(
            config.phase_kinds, param_slots, fetched[1 + C :]
        )

        # ONE slant-tau evaluation (from the fused event kernel) serves
        # both the volume and surface NEE branches
        T_sun = jnp.exp(-jnp.minimum(tau_sun, 80.0))

        cos_nee = -jnp.sum(d_sun * d, axis=-1)
        p_nee = jax.vmap(
            lambda w_at, p_at, c: phase_eval_at(
                config.phase_kinds, medium_row.phase_params, w_at, p_at, c
            )
        )(weights_at, params_at, cos_nee)
        L_col = beta * r_col * albedo_col * p_nee * T_sun * E_sun

        def _sample_one(w_at, p_at, dd, us, uc, up):
            return phase_sample_at(
                config.phase_kinds,
                medium_row.phase_params,
                w_at,
                p_at,
                dd,
                us,
                uc,
                up,
            )

        d_col = jax.vmap(_sample_one)(
            weights_at, params_at, d, u_ph_sel, u_ph_cos, u_ph_phi
        )
        beta_col = beta * r_col * albedo_col

        # ---- surface interaction ---------------------------------------
        r_new = jnp.linalg.norm(p_new, axis=-1)
        n_srf = p_new / jnp.maximum(r_new[:, None], 1e-12)
        mu_sun_srf = jnp.sum(n_srf * w_sun, axis=-1)
        wo_local = _to_local(n_srf, -d)
        wi_sun_local = _to_local(n_srf, jnp.broadcast_to(w_sun, p_new.shape))
        # positional argument: local tangent coordinates (textures)
        f_nee = bsdf_eval(
            config.surface_kind, surface_row.params, wi_sun_local, wo_local, None
        )
        L_srf = (
            beta
            * r_bnd
            * f_nee
            * jnp.maximum(mu_sun_srf, 0.0)
            * T_sun
            * E_sun
        )
        d_srf_local, w_srf = bsdf_sample_from_uniforms(
            config.surface_kind, surface_row.params, wo_local, u_srf
        )
        d_srf = _to_world(n_srf, d_srf_local)
        beta_srf = beta * r_bnd * w_srf
        # lift off the surface to avoid re-intersection
        p_srf = p_new + n_srf * eps_t

        # ---- combine ----------------------------------------------------
        contribution = jnp.where(
            accept, L_col, jnp.where(hit_surface, L_srf, 0.0)
        )
        p2 = jnp.where(hit_surface[:, None], p_srf, p_new)
        d2 = jnp.where(
            accept[:, None], d_col, jnp.where(hit_surface[:, None], d_srf, d)
        )
        beta2 = jnp.where(
            accept, beta_col, jnp.where(hit_surface, beta_srf, beta)
        )
        interacted = accept | hit_surface
        escaped = ~accept & ~hit_surface
        alive2 = ~escaped & (beta2 > 0.0)
        depth2 = depth + jnp.where(interacted & alive2, 1, 0)

        # ---- Russian roulette (on real interactions past rr_depth) ------
        do_rr = interacted & (depth2 >= config.rr_depth)
        q = jnp.clip(beta2, 0.0, 0.95)
        survive = u_rr < q
        beta2 = jnp.where(do_rr & alive2 & survive, beta2 / q, beta2)
        alive2 = alive2 & jnp.where(do_rr, survive, True)
        alive2 = alive2 & (depth2 < config.max_depth)

        return contribution, p2, d2, beta2, depth2, alive2

    return event


def trace_paths_spherical(
    config: SceneConfig,
    medium_row,
    surface_row,
    illum_row,
    init_p,
    init_d,
    keys,
    max_iterations: int,
):
    """One-shot loop: one sample per lane (kept as the reference
    implementation; the regenerative loop below is the production path)."""
    B = init_p.shape[0]
    event = _make_event(config, medium_row, surface_row, illum_row)

    def body(carry):
        it, p, d, beta, L, alive, depth, keys = carry
        contribution, p2, d2, beta2, depth2, alive2 = event(
            jnp.full(B, it), p, d, beta, depth, keys
        )
        L = L + jnp.where(alive, contribution, 0.0)
        alive = alive & alive2
        return (it + 1, p2, d2, beta2, L, alive, depth2, keys)

    def cond(carry):
        it = carry[0]
        alive = carry[5]
        return (it < max_iterations) & jnp.any(alive)

    init = (
        jnp.asarray(0),
        init_p,
        init_d,
        jnp.ones(B, init_p.dtype),
        jnp.zeros(B, init_p.dtype),
        jnp.ones(B, dtype=bool),
        jnp.zeros(B, dtype=jnp.int32),
        keys,
    )
    final = jax.lax.while_loop(cond, body, init)
    return final[4]


def trace_paths_spherical_regen(
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
    """Regenerative shell trace: each lane renders ``quota`` samples,
    re-seeding a fresh path the moment one dies (see
    :func:`eradiate_tpu.ops.tracer.trace_paths_regen` for rationale).
    ``evt`` counts events since the current path's start, so the
    per-sample RNG stream ``fold_in(fold_in(row_key, sample_id), evt)``
    is identical to the one-shot tracer's."""
    B = init_p.shape[0]
    dtype = init_p.dtype
    event = _make_event(config, medium_row, surface_row, illum_row)
    row_keys_b = jnp.broadcast_to(row_key, (B,))

    def sample_key(s_local):
        return derive_keys(config.rng, row_keys_b, lane_first + s_local)

    def body(carry):
        (s_local, evt, depth, p, d, beta, L_cur, keys, done,
         L_sum, m2_sum) = carry

        contribution, p2, d2, beta2, depth2, alive2 = event(
            evt, p, d, beta, depth, keys
        )
        active = ~done
        L_cur = L_cur + jnp.where(active, contribution, 0.0)
        evt = evt + 1
        path_end = active & (~alive2 | (evt >= max_iterations))

        L_sum = L_sum + jnp.where(path_end, L_cur, 0.0)
        m2_sum = m2_sum + jnp.where(path_end, L_cur * L_cur, 0.0)
        s_local = s_local + path_end.astype(s_local.dtype)
        done = done | (s_local >= quota)

        regen = path_end & ~done
        keys = jnp.where(regen, sample_key(s_local), keys)
        p = jnp.where(regen[:, None], init_p, p2)
        d = jnp.where(regen[:, None], init_d, d2)
        beta = jnp.where(regen, jnp.ones((), dtype), beta2)
        depth = jnp.where(regen, 0, depth2)
        evt = jnp.where(regen, 0, evt)
        L_cur = jnp.where(path_end, 0.0, L_cur)

        return (s_local, evt, depth, p, d, beta, L_cur, keys, done,
                L_sum, m2_sum)

    def cond(carry):
        return jnp.any(~carry[8])

    init = (
        jnp.zeros(B, jnp.int32),
        jnp.zeros(B, jnp.int32),
        jnp.zeros(B, jnp.int32),
        init_p,
        init_d,
        jnp.ones(B, dtype),
        jnp.zeros(B, dtype),
        sample_key(jnp.zeros(B, jnp.int32)),
        jnp.zeros(B, dtype=bool),
        jnp.zeros(B, dtype),
        jnp.zeros(B, dtype),
    )
    final = jax.lax.while_loop(cond, body, init)
    return final[9], final[10]


def _render_row_spherical(
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

    w_v = directions[pix]  # toward the sensor
    # start at TOA along the viewing ray through the target
    _, t_far, _ = ray_sphere_intersect(
        jnp.broadcast_to(target, (B, 3)), w_v, r_top
    )
    init_p = target[None, :] + w_v * t_far[:, None]
    init_d = -w_v

    L_sum, m2_sum = trace_paths_spherical_regen(
        config, medium_row, surface_row, illum_row, init_p, init_d, key,
        lane_first, quota, max_iterations,
    )
    radiance = jnp.sum(L_sum.reshape(n_pix, lp), axis=1) / spp
    m2 = jnp.sum(m2_sum.reshape(n_pix, lp), axis=1) / spp
    return radiance, m2


def render_batch_spherical_impl(
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
        return _render_row_spherical(
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


_render_batch_spherical = jax.jit(
    render_batch_spherical_impl, static_argnums=(0, 1, 2, 3)
)


def render_spherical(
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
    """Render the spectral batch through a spherical-shell atmosphere.

    The regenerative loop bounds memory by lane count (not spp), so the
    whole sample budget runs in one dispatch; ``spp_chunk`` remains
    available for callers that stream accumulators (checkpointing).
    """
    directions = jnp.asarray(sensor.directions)
    target = jnp.asarray(sensor.target)
    n_pix = directions.shape[0]
    S = scene_medium.sigma_t.shape[0]

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
        rad, m2 = _render_batch_spherical(
            config, n_pix, n, max_iterations, scene_medium, surface, illum,
            directions, target, chunk_keys,
        )
        rad_sum = rad_sum + rad * n
        m2_sum = m2_sum + m2 * n
        traced += n

    return {"radiance": rad_sum / traced, "m2": m2_sum / traced, "spp": traced}
