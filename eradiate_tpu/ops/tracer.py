"""Wavefront volumetric path tracer (plane-parallel geometry).

The JAX replacement for the reference's hot path — the C++
``mi.render`` call driving ``piecewise_volpath``/``volpath`` integrators
inside a serial spectral loop (``kernel/_render.py:379-468``; SURVEY §3.4).

Design (SURVEY §7.1 "engine"):

- **SoA path state** batched over {spectral index x pixel x sample}; the
  whole spectral dimension is device-resident and vmapped — there is no
  per-wavelength host round trip.
- **Exact free-flight sampling** through the layered medium via closed-form
  inversion of the cumulative vertical optical depth (see
  :mod:`eradiate_tpu.ops.medium`) — the deterministic-transmittance
  equivalent of the reference's ``piecewise`` medium.
- **Next-event estimation** toward the directional emitter at every volume
  collision and surface bounce. Directional emitters are delta
  distributions, so NEE is the only sampling strategy that reaches them and
  carries MIS weight 1 (finite-size astro objects add a cone term later).
- **Path regeneration**: lanes re-seed a fresh (pixel, sample) path the
  moment one dies (``trace_paths_regen``), keeping every ``while_loop``
  iteration ~100% utilized; Russian roulette kills paths after
  ``rr_depth``, ``max_depth`` bounds each sample.
- Radiance and second-moment accumulators are computed per (pixel), the
  moment being over per-sample path contributions (mirror of the reference's
  ``moment`` integrator semantics, ``_path_tracers.py:68-69``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .fastrng import bounce_uniforms, derive_keys, origin_uniforms

from .bsdf_ops import bsdf_eval, bsdf_sample_from_uniforms
from .medium import clamp_mu, collision_fetch, tau_at_z
from .phase_ops import (
    layer_param_slots,
    phase_eval_at,
    phase_sample_at,
    rebuild_fetched,
)
from .scene_state import (
    IlluminationArrays,
    MediumArrays,
    SceneArrays,
    SceneConfig,
    SensorArrays,
    SurfaceArrays,
)

__all__ = ["render", "trace_paths"]


def _make_bounce(config: SceneConfig, medium_row, surface_row, illum_row):
    """Build the per-bounce transition closure shared by the one-shot and
    regenerative path loops.

    The returned ``bounce(depth_b, z, tau_here, xy, d, beta, keys,
    u0_dist)`` advances every lane by one path vertex and returns
    ``(contribution, z', tau', xy', d', beta', alive')`` — state updates are
    unconditional (callers mask dead lanes), matching the physics of the
    reference's ``piecewise_volpath`` integrator (SURVEY §2.1).
    """
    z_levels = medium_row.z_levels
    tau_levels = medium_row.tau_levels
    tau_top = tau_levels[-1]
    z_bottom = z_levels[0]

    d_sun = illum_row.direction  # propagation, pointing down
    w_sun = -d_sun  # unit vector toward the sun center
    E_sun = illum_row.irradiance  # scalar for this spectral slice
    L_sky = illum_row.sky_radiance  # uniform environment radiance
    cos_cutoff = illum_row.cos_cutoff  # 1.0 = ideal directional emitter

    def sample_sun_dirs(u):
        """Cone-sampled directions toward the (possibly finite-size) sun
        from pre-drawn uniforms ``u`` [B, 2].

        For an astro-object emitter the irradiance spreads over the disk
        solid angle; uniform cone sampling with pdf 1/Omega makes the NEE
        weight exactly E (reference ``astroobject`` plugin semantics,
        ``scenes/illumination/_astro_object.py:17-79``). cos_cutoff = 1
        degenerates to the exact directional case.
        """
        from ..core.warp import square_to_uniform_cone
        from .phase_ops import ortho_frame

        local = square_to_uniform_cone(u, cos_cutoff)
        t1, t2 = ortho_frame(w_sun)
        return (
            t1[None, :] * local[:, 0:1]
            + t2[None, :] * local[:, 1:2]
            + w_sun[None, :] * local[:, 2:3]
        )

    # per-layer tables fetched in ONE fused dense pass per bounce: albedo,
    # blend weights, layer-indexed component params (e.g. Rayleigh depol)
    C = len(config.phase_kinds)
    param_tables, param_slots = layer_param_slots(
        config.phase_kinds, medium_row.phase_params
    )
    # per-layer vertical depth increments, fetched ATTACHED (their tangent
    # carries d log sigma for the likelihood-ratio weights; lr_flight only)
    _lr = bool(getattr(config, "lr_flight", False))
    fetch_tables = (
        ([jnp.diff(tau_levels)] if _lr else [])
        + [medium_row.albedo]
        + [medium_row.phase_weights[c] for c in range(C)]
        + param_tables
    )
    _off = 1 if _lr else 0

    def bounce(depth_b, z, tau_here, xy, d, beta, keys, u0_dist=None, ld=None):
        # ONE batched threefry draw per bounce: per-purpose key splits +
        # separate uniform() calls cost ~40 tiny [B]-shaped kernels per
        # iteration (~79 us/iter at B=16k, as large as all the physics);
        # a single [B, 10] draw from the iteration key collapses them.
        if ld is not None:
            # full-dimension padded low-discrepancy sampling: every MC
            # decision of every bounce draws an Owen-scrambled VdC point
            # indexed by the lane's global sample slot (VERDICT r1 #5;
            # reference samplers drive all dims,
            # scenes/measure/_core.py:142-154)
            from .samplers import padded_bounce_uniforms

            slot, pix_seed = ld
            U = padded_bounce_uniforms(slot, pix_seed, depth_b)
        else:
            U = bounce_uniforms(config.rng, keys, depth_b, 10)
        u_dist = U[:, 0]
        u_sun = U[:, 1:3]
        u_ph_sel, u_ph_cos, u_ph_phi = U[:, 3], U[:, 4:6], U[:, 6]
        u_srf = U[:, 7:9]
        u_rr = U[:, 9]

        w_nee = sample_sun_dirs(u_sun)  # [B, 3] toward the sun
        mu_nee = clamp_mu(w_nee[:, 2])

        mu = clamp_mu(d[:, 2])
        tau_exit = jnp.where(
            mu > 0.0, (tau_top - tau_here) / mu, tau_here / (-mu)
        )
        u = u_dist
        if u0_dist is not None:
            # primary-dimension override: stratified/LD samplers structure
            # the first flight; subsequent bounces are path-divergent
            u = jnp.where(depth_b == 0, u0_dist, u)
        tau_s = -jnp.log1p(-u)
        collide = tau_s < tau_exit

        # ---- volume collision ------------------------------------------
        # lr_flight: sampling geometry is DETACHED (stop_gradient) —
        # collision altitudes and event choices come from the primal
        # medium, and the medium's parameter dependence re-enters through
        # smooth likelihood-ratio weights (r_col / r_bnd). This makes
        # forward-mode derivatives w.r.t. extinction parameters unbiased
        # (the attached-inversion "reparameterized" tangent drops the
        # collide-vs-boundary flip term — measured sign-level bias, see
        # eradiate_tpu/sensitivity.py). All correction factors are
        # primal-neutral (exp(g - sg(g)) == 1.0, x + (a - sg(a)) == x
        # exactly), so the two flag settings render bit-identically;
        # production (flag off) skips the extra tangent plumbing (~7%
        # on c1-class scenes: one fetch column + a tau(z) interpolation
        # per bounce).
        sg = jax.lax.stop_gradient if _lr else (lambda x: x)
        tau_new_smp = jnp.clip(sg(tau_here) + mu * tau_s, 0.0, sg(tau_top))
        z_col, layer, fetched = collision_fetch(
            tau_new_smp, z_levels, sg(tau_levels), fetch_tables
        )
        albedo_col = fetched[_off]
        weights_at = jnp.stack(
            fetched[_off + 1 : _off + 1 + C], axis=-1
        )  # [B, C]
        params_at = rebuild_fetched(
            config.phase_kinds, param_slots, fetched[_off + 1 + C :]
        )
        if _lr:
            # attached tau at the FIXED collision altitude; primal equals
            # the sampled tau exactly via the primal-neutral form
            tau_new_att = tau_at_z(z_col, z_levels, tau_levels)
            tau_new = tau_new_smp + (tau_new_att - sg(tau_new_att))
            # log-likelihood ratio of the attached vs sampling medium:
            # collision density  sigma(z) exp(-tau_path)  at fixed z
            # (sigma ratio via the layer's dtau: dz is theta-independent);
            # boundary probability  exp(-tau_exit).
            tau_path = jnp.abs(tau_new - tau_here) / jnp.abs(mu)
            g_col = jnp.log(jnp.maximum(fetched[0], 1e-30)) - tau_path
            r_col = jnp.exp(g_col - sg(g_col))  # primal exactly 1.0
            r_bnd = jnp.exp(-(tau_exit - sg(tau_exit)))  # primal 1.0
        else:
            tau_new = tau_new_smp
            r_col = r_bnd = 1.0
        s_col = (z_col - z) / mu
        xy_col = xy + d[:, :2] * s_col[:, None]

        # NEE: sun propagation -w_nee scattered into -d (toward sensor
        # path). The collision's vertical tau IS tau_new, so the sun-path
        # transmittance is closed-form — no second table inversion.
        cos_nee = jnp.sum(w_nee * d, axis=-1)
        p_nee = jax.vmap(
            lambda w_at, p_at, c: phase_eval_at(
                config.phase_kinds, medium_row.phase_params, w_at, p_at, c
            )
        )(weights_at, params_at, cos_nee)
        T_sun_col = jnp.exp(-(tau_top - tau_new) / mu_nee)
        L_col = beta * r_col * albedo_col * p_nee * T_sun_col * E_sun

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

        # ---- surface hit ------------------------------------------------
        hit_surface = (~collide) & (mu < 0.0) & config.has_surface
        s_surf = (z_bottom - z) / mu
        xy_surf = xy + d[:, :2] * s_surf[:, None]
        wo = -d  # toward the sensor path (upward at surface hits)
        T_sun_bottom = jnp.exp(-tau_top / mu_nee)
        f_nee = bsdf_eval(
            config.surface_kind, surface_row.params, w_nee, wo, xy_surf
        )
        L_surf = beta * r_bnd * f_nee * mu_nee * T_sun_bottom * E_sun
        d_surf, w_surf = bsdf_sample_from_uniforms(
            config.surface_kind, surface_row.params, wo, u_srf, xy_surf
        )
        beta_surf = beta * r_bnd * w_surf

        # ---- combine ----------------------------------------------------
        contribution = jnp.where(
            collide,
            L_col,
            # escaping paths collect the uniform sky radiance
            jnp.where(hit_surface, L_surf, beta * r_bnd * L_sky),
        )
        z2 = jnp.where(collide, z_col, z_bottom)
        tau2 = jnp.where(collide, tau_new, 0.0)
        xy2 = jnp.where(collide[:, None], xy_col, xy_surf)
        d2 = jnp.where(collide[:, None], d_col, d_surf)
        beta2 = jnp.where(
            collide, beta_col, jnp.where(hit_surface, beta_surf, 0.0)
        )
        alive2 = (collide | hit_surface) & (beta2 > 0.0)

        # ---- Russian roulette ------------------------------------------
        do_rr = depth_b >= config.rr_depth
        q = jnp.clip(beta2, 0.0, 0.95)
        survive = u_rr < q
        beta2 = jnp.where(do_rr & alive2 & survive, beta2 / q, beta2)
        alive2 = alive2 & jnp.where(do_rr, survive, True)

        return contribution, z2, tau2, xy2, d2, beta2, alive2

    return bounce


def trace_paths(
    config: SceneConfig,
    medium_row,
    surface_row,
    illum_row,
    init_z,
    init_xy,
    init_d,
    keys,
    u0_dist=None,
    ld=None,
):
    """Trace a batch of paths through one spectral slice (one sample per
    lane).

    All per-path inputs have leading batch axis [B]; medium/surface/illum
    rows are per-spectral-index slices (no S axis). Returns per-path
    radiance estimates [B]. ``u0_dist`` [B] optionally overrides the
    first-flight distance uniform (stratified/low-discrepancy samplers);
    ``ld = (slot, pix_seed)`` switches every bounce dimension to padded
    Owen-scrambled points (see :func:`samplers.padded_bounce_uniforms`).
    """
    B = init_z.shape[0]
    bounce = _make_bounce(config, medium_row, surface_row, illum_row)

    def body(carry):
        depth, z, tau_here, xy, d, beta, L, alive, keys = carry
        contribution, z2, tau2, xy2, d2, beta2, alive2 = bounce(
            jnp.full(B, depth), z, tau_here, xy, d, beta, keys, u0_dist,
            ld=ld,
        )
        L = L + jnp.where(alive, contribution, 0.0)
        alive = alive & alive2
        return (depth + 1, z2, tau2, xy2, d2, beta2, L, alive, keys)

    def cond(carry):
        depth = carry[0]
        alive = carry[7]
        return (depth < config.max_depth) & jnp.any(alive)

    init = (
        jnp.asarray(0),
        init_z,
        # vertical tau at the ray origins: the only tau(z) table lookup of
        # the whole trace — afterwards tau is carried through the loop
        tau_at_z(init_z, medium_row.z_levels, medium_row.tau_levels),
        init_xy,
        init_d,
        jnp.ones(B, init_z.dtype),
        jnp.zeros(B, init_z.dtype),
        jnp.ones(B, dtype=bool),
        keys,
    )
    final = jax.lax.while_loop(cond, body, init)
    return final[6]


def trace_paths_regen(
    config: SceneConfig,
    medium_row,
    surface_row,
    illum_row,
    init_z,
    init_xy,
    init_d,
    row_key,
    lane_first,
    quota,
    ext=None,
):
    """Regenerative wavefront trace: each lane renders ``quota`` samples.

    The one-shot loop (:func:`trace_paths`) wastes most of its iterations:
    mean useful path depth on atmosphere scenes is ~2–3 bounces while the
    batch-wide ``while_loop`` runs until the *longest* path dies (~13+
    trips measured) — >75% of every [B, L]-shaped pass processes dead
    lanes. Here a lane immediately re-initializes a fresh path (next sample
    of its pixel) the moment one terminates, keeping lane utilization near
    100%: total iterations ~= quota x E[depth] + one straggler tail,
    instead of quota x max-tail. Lane count is then sized to saturate the
    chip rather than to hold the whole sample budget (classic wavefront
    path regeneration).

    RNG: sample ``s`` of lane ``l`` uses ``fold_in(row_key,
    lane_first[l] + s)`` where ``lane_first`` partitions each pixel's
    contiguous sample-id range [pixel * spp, pixel * spp + spp) across its
    lanes — keys depend only on (pixel, global sample index), so the sample
    set (and hence the estimate, up to float summation order) is invariant
    to the lane/quota decomposition and matches the one-shot tracer
    exactly. ``quota`` may be per-lane ([B] int) to cover ``spp`` not
    divisible by lanes-per-pixel.

    ``init_z/init_xy/init_d`` are per-lane ray anchors (constant across a
    lane's samples — plane-parallel distant sensors fix the direction and
    start altitude per pixel); ``ext`` [B, 2] optionally jitters the xy
    origin per sample over a centered rectangle (rectangle targets).
    Returns ``(L_sum, m2_sum)`` per lane, summed over its samples.
    """
    B = init_z.shape[0]
    dtype = init_z.dtype
    bounce = _make_bounce(config, medium_row, surface_row, illum_row)
    tau0 = tau_at_z(init_z, medium_row.z_levels, medium_row.tau_levels)
    row_keys_b = jnp.broadcast_to(row_key, (B,))

    def sample_key(s_local):
        return derive_keys(config.rng, row_keys_b, lane_first + s_local)

    def origin_xy(keys):
        if ext is None:
            return init_xy
        u = origin_uniforms(config.rng, keys, 2, dtype=dtype)
        return init_xy + (u - 0.5) * ext

    def body(carry):
        (s_local, depth, z, tau_here, xy, d, beta, L_cur, keys, done,
         L_sum, m2_sum) = carry

        contribution, z2, tau2, xy2, d2, beta2, alive2 = bounce(
            depth, z, tau_here, xy, d, beta, keys
        )
        active = ~done
        L_cur = L_cur + jnp.where(active, contribution, 0.0)
        depth = depth + 1
        # path ends on absorption/escape/RR kill or at the depth cap
        path_end = active & (~alive2 | (depth >= config.max_depth))

        # close out finished samples
        L_sum = L_sum + jnp.where(path_end, L_cur, 0.0)
        m2_sum = m2_sum + jnp.where(path_end, L_cur * L_cur, 0.0)
        s_local = s_local + path_end.astype(s_local.dtype)
        done = done | (s_local >= quota)

        # regenerate: fresh path for the lane's next sample
        regen = path_end & ~done
        keys_new = sample_key(s_local)
        keys = jnp.where(regen, keys_new, keys)
        xy_new = origin_xy(keys_new)
        z = jnp.where(regen, init_z, z2)
        tau_here = jnp.where(regen, tau0, tau2)
        xy = jnp.where(regen[:, None], xy_new, xy2)
        d = jnp.where(regen[:, None], init_d, d2)
        beta = jnp.where(regen, jnp.ones((), dtype), beta2)
        L_cur = jnp.where(path_end, 0.0, L_cur)
        depth = jnp.where(regen, 0, depth)

        return (s_local, depth, z, tau_here, xy, d, beta, L_cur, keys,
                done, L_sum, m2_sum)

    def cond(carry):
        return jnp.any(~carry[9])

    keys0 = sample_key(jnp.zeros(B, jnp.int32))
    init = (
        jnp.zeros(B, jnp.int32),
        jnp.zeros(B, jnp.int32),
        init_z,
        tau0,
        origin_xy(keys0),
        init_d,
        jnp.ones(B, dtype),
        jnp.zeros(B, dtype),
        keys0,
        jnp.zeros(B, dtype=bool),
        jnp.zeros(B, dtype),
        jnp.zeros(B, dtype),
    )
    final = jax.lax.while_loop(cond, body, init)
    return final[10], final[11]


def _per_path_targets(target, target_extent, pix, key, dtype):
    """Expand sensor targets to per-path points [B, 3].

    ``target`` may be [3] (shared) or [N, 3] (per-pixel, mpdistant);
    ``target_extent`` ([2] or [N, 2]) jitters origins uniformly over a
    centered rectangle — the equivalent of the reference's rectangle
    target sampling (``scenes/measure/_distant.py:139-228``).
    """
    B = pix.shape[0]
    if target is None:
        tgt = jnp.zeros((B, 3), dtype)
    elif target.ndim == 2:
        tgt = target[pix]
    else:
        tgt = jnp.broadcast_to(target, (B, 3))
    if target_extent is not None:
        ext = target_extent[pix] if target_extent.ndim == 2 else target_extent
        u = jax.random.uniform(
            jax.random.fold_in(key, 0x7A19), (B, 2), dtype=tgt.dtype
        )
        jitter = (u - 0.5) * ext
        tgt = tgt + jnp.concatenate(
            [jitter, jnp.zeros((B, 1), tgt.dtype)], axis=-1
        )
    return tgt


#: Lane-count target for the regenerative tracer: enough lanes to fill the
#: device, few enough that lanes multiplex many samples each (regeneration
#: amortizes the straggler tail over a lane's quota). The value was tuned
#: on the previous accelerator and is correct on any device; a GPU sweep
#: is an open item (ROADMAP, Speed).
REGEN_LANES_TARGET = 2**14


#: Minimum samples per lane before extra lanes stop paying: regeneration
#: amortizes the straggler tail over a lane's quota, so quota ~ 1 degrades
#: to the one-shot loop no matter how many lanes run.
_QUOTA_FLOOR = 8


def _lane_plan(
    n_pix: int, spp: int, lanes_target: int | None = None
) -> tuple[int, int]:
    """(lanes_per_pixel, max quota) for the regenerative tracer."""
    if lanes_target is None:
        lanes_target = REGEN_LANES_TARGET  # late-bound: tunable per run
    lp = max(1, min(spp, lanes_target // max(n_pix, 1)))
    lp = min(lp, max(1, spp // _QUOTA_FLOOR))
    quota = -(-spp // lp)
    return lp, quota


def lane_partition(
    n_pix: int,
    spp: int,
    lanes_target: int | None = None,
    spp_stride: int | None = None,
    sample_offset=None,
):
    """Exact-spp lane partition shared by the regenerative tracers.

    Returns ``(lp, pix, slot, lane_first, quota)``: ``n_pix * lp`` lanes;
    lane ``(pixel, slot)`` renders samples ``lane_first .. lane_first +
    quota - 1`` where sample ids tile ``[pixel * spp, (pixel + 1) * spp)``
    exactly (the first ``spp % lp`` slots of each pixel take one extra
    sample). Keys derived from these ids depend only on (pixel, sample),
    so estimates are invariant to the decomposition.

    ``lanes_target`` is geometry-dependent: the plane-parallel tracer uses
    :data:`REGEN_LANES_TARGET`, the spherical tracers an adaptive target
    (``tracer_spherical.spherical_lanes_target``).

    Distribution hooks (:mod:`eradiate_tpu.parallel.render`): ``spp_stride``
    (static, default ``spp``) is the per-pixel width of the *global*
    sample-id range and ``sample_offset`` (may be a traced scalar —
    ``axis_index('sample') * spp_local`` inside ``shard_map``) shifts this
    shard's ids within it, so the union over sample-axis devices is exactly
    the single-device id set ``[pixel * spp_stride, pixel * spp_stride +
    spp_stride)`` — sharded estimates equal unsharded ones up to float
    summation order.
    """
    lp, _ = _lane_plan(n_pix, spp, lanes_target)
    stride = spp if spp_stride is None else spp_stride
    pix = jnp.repeat(jnp.arange(n_pix), lp)
    slot = jnp.tile(jnp.arange(lp), n_pix)
    q_lo, rem = divmod(spp, lp)
    quota = jnp.where(slot < rem, q_lo + 1, q_lo)
    start = jnp.where(
        slot < rem, slot * (q_lo + 1), rem * (q_lo + 1) + (slot - rem) * q_lo
    )
    lane_first = pix * stride + start
    if sample_offset is not None:
        lane_first = lane_first + sample_offset
    return lp, pix, slot, lane_first, quota


def _ray_anchors(
    config, medium_row, pix, directions, key, target, ray_offset,
    target_extent, with_jitter,
):
    """Per-lane ray anchors (init_z, init_xy, init_d, ext).

    ``with_jitter=True`` applies rectangle-target jitter here (one-shot
    tracer); ``False`` returns the un-jittered anchors plus the per-lane
    extent so the regenerative tracer can re-jitter per sample.
    """
    z_top = medium_row.z_levels[-1]
    w_v = directions[pix]
    init_d = -w_v  # into the scene
    ext = None
    if with_jitter:
        tgt = _per_path_targets(target, target_extent, pix, key, w_v.dtype)
    else:
        tgt = _per_path_targets(target, None, pix, key, w_v.dtype)
        if target_extent is not None:
            ext = (
                target_extent[pix]
                if target_extent.ndim == 2
                else jnp.broadcast_to(target_extent, (pix.shape[0], 2))
            )
    if ray_offset is None:
        ray_offset = jnp.asarray(jnp.nan)
    t_start = jnp.where(
        jnp.isnan(ray_offset),
        (z_top - tgt[:, 2]) / clamp_mu(w_v[:, 2]),
        ray_offset,
    )
    init_z = jnp.clip(tgt[:, 2] + w_v[:, 2] * t_start, None, z_top)
    init_xy = tgt[:, :2] + w_v[:, :2] * t_start[:, None]
    return init_z, init_xy, init_d, ext


def _render_row_regen(
    config, n_pix, spp, medium_row, surface_row, illum_row, directions, key,
    target=None, ray_offset=None, target_extent=None, sample_offset=None,
    spp_stride=None,
):
    """Render one spectral slice with the regenerative tracer
    (``independent`` sampler): [n_pix * lanes_per_pixel] lanes x quota
    samples each."""
    lp, pix, slot, lane_first, quota = lane_partition(
        n_pix, spp, spp_stride=spp_stride, sample_offset=sample_offset
    )
    B = n_pix * lp

    init_z, init_xy, init_d, ext = _ray_anchors(
        config, medium_row, pix, directions, key, target, ray_offset,
        target_extent, with_jitter=False,
    )
    L_sum, m2_sum = trace_paths_regen(
        config, medium_row, surface_row, illum_row, init_z, init_xy, init_d,
        key, lane_first, quota, ext=ext,
    )
    radiance = jnp.sum(L_sum.reshape(n_pix, lp), axis=1) / spp
    m2 = jnp.sum(m2_sum.reshape(n_pix, lp), axis=1) / spp
    return radiance, m2


def _render_row(
    config, n_pix, spp, medium_row, surface_row, illum_row, directions, key,
    target=None, ray_offset=None, target_extent=None, sample_offset=None,
    spp_stride=None,
):
    """Render one spectral slice: [N] pixels x spp samples.

    Rays start at TOA on the line through ``target`` unless ``ray_offset``
    is finite, in which case they start at ``target + ray_offset * w_v``
    (in-atmosphere sensor placement, mirror of mdistant's ``ray_offset``,
    ``scenes/measure/_distant.py:334-361``).

    ``sample_offset``/``spp_stride``: global sample-id slicing for the
    distributed path (see :func:`lane_partition`); the structured point
    sets of non-independent samplers stratify within each shard's local
    ``spp`` (decorrelated across shards), so sample sharding preserves the
    estimator in distribution but not the exact point set.
    """
    B = n_pix * spp

    stride = spp if spp_stride is None else spp_stride
    pix = jnp.repeat(jnp.arange(n_pix), spp)
    path_ids = pix * stride + jnp.tile(jnp.arange(spp), n_pix)
    if sample_offset is not None:
        path_ids = path_ids + sample_offset
    init_z, init_xy, init_d, _ = _ray_anchors(
        config, medium_row, pix, directions, key, target, ray_offset,
        target_extent, with_jitter=True,
    )

    # same derivation as the regenerative loop's sample_key — the
    # one-shot == regenerative equality gate depends on it
    keys = derive_keys(config.rng, jnp.broadcast_to(key, (B,)), path_ids)

    if config.sampler != "independent":
        from .samplers import primary_samples

        # per-pixel point sets, decorrelated by folding the pixel index
        # into a sampler-domain subkey (distinct from the path-key domain)
        k_sampler = jax.random.fold_in(key, 0x5A17)
        if sample_offset is not None:
            k_sampler = jax.random.fold_in(k_sampler, sample_offset)
        pix_keys = jax.vmap(jax.random.fold_in)(
            jnp.broadcast_to(k_sampler, (n_pix,)), jnp.arange(n_pix)
        )
        u0 = jax.vmap(lambda k: primary_samples(config.sampler, spp, k))(
            pix_keys
        ).reshape(B)
        u0 = u0.astype(init_z.dtype)
        # pad every other (depth, purpose) dimension with Owen-scrambled
        # VdC points over the pixel's GLOBAL sample-id range: the kind's
        # own point set keeps the primary dimension, padding structures
        # the rest (VERDICT r1 #5). Slots/seeds are rank-independent, so
        # the sharded point set equals the single-device one.
        slot = path_ids - pix * stride
        pix_seed = jax.random.bits(
            jax.random.fold_in(key, 0x0E11), (n_pix,), jnp.uint32
        )[pix]
        ld = (slot.astype(jnp.uint32), pix_seed)
    else:
        u0 = None
        ld = None

    L = trace_paths(
        config, medium_row, surface_row, illum_row, init_z, init_xy, init_d,
        keys, u0_dist=u0, ld=ld,
    )
    L = L.reshape(n_pix, spp)
    radiance = jnp.mean(L, axis=1)
    m2 = jnp.mean(L * L, axis=1)
    return radiance, m2


def render_batch_impl(
    config, n_pix, spp, medium, surface, illum, directions, keys,
    target=None, ray_offset=None, target_extent=None, sample_offset=None,
    spp_stride=None,
):
    """Spectral-batched render (traceable; see ``_render_batch`` for the
    jitted entry). ``keys`` has leading spectral axis [S].

    Spectral rows run through ``lax.map`` (a scan), not ``vmap``: each
    row's loop stays a rank-2 program, and each row still traces n_pix x
    spp paths. (On the previous accelerator, vmapping the loop turned the
    one-hot table fetch into a rank-3 batched matmul that did not fuse
    and ran 7x slower; whether vmap over rows pays on the GPU is still to
    be measured.)

    ``sample_offset`` (traced scalar) / ``spp_stride`` (static) slice the
    global per-pixel sample-id range for the sharded product path
    (:mod:`eradiate_tpu.parallel.render`).
    """
    z_levels = medium.z_levels

    row_fn = (
        _render_row_regen if config.sampler == "independent" else _render_row
    )

    def one_row(args):
        mr_part, sr, ir, k = args
        mr = MediumArrays(
            z_levels=z_levels,
            tau_levels=mr_part[0],
            albedo=mr_part[1],
            phase_weights=mr_part[2],
            phase_params=mr_part[3],
        )
        return row_fn(
            config, n_pix, spp, mr, sr, ir, directions, k, target, ray_offset,
            target_extent, sample_offset=sample_offset, spp_stride=spp_stride,
        )

    med_part = (
        medium.tau_levels,
        medium.albedo,
        medium.phase_weights,
        medium.phase_params,
    )
    illum_bcast = IlluminationArrays(
        direction=jnp.broadcast_to(
            illum.direction, keys.shape[:1] + illum.direction.shape
        ),
        irradiance=illum.irradiance,
        cos_cutoff=jnp.broadcast_to(illum.cos_cutoff, keys.shape[:1]),
        sky_radiance=illum.sky_radiance,
        position=None
        if illum.position is None
        else jnp.broadcast_to(illum.position, keys.shape[:1] + (3,)),
    )
    return jax.lax.map(one_row, (med_part, surface, illum_bcast, keys))


_render_batch = jax.jit(render_batch_impl, static_argnums=(0, 1, 2))


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _render_full(
    config, n_pix, spp_chunk, n_chunks, medium, surface, illum, directions,
    target, ray_offset, seed, target_extent=None,
):
    """Whole-measure render in ONE device program: key derivation, a scan
    over sample chunks and the accumulator arithmetic all live on device.

    Rationale: every host-side op is a separate dispatch, and a wrapper of
    ~10 small jnp calls can cost more than a small render itself. One
    dispatch per measure also keeps the driver loop overlap-friendly on
    multi-device runs.
    """
    S = medium.tau_levels.shape[0]
    base_key = jax.random.key(seed)
    row_keys = jax.vmap(jax.random.fold_in)(
        jnp.broadcast_to(base_key, (S,)), jnp.arange(S)
    )

    def chunk_body(carry, chunk_id):
        rad_sum, m2_sum = carry
        chunk_keys = jax.vmap(jax.random.fold_in)(
            row_keys, jnp.full(S, chunk_id)
        )
        rad, m2 = render_batch_impl(
            config, n_pix, spp_chunk, medium, surface, illum, directions,
            chunk_keys, target, ray_offset, target_extent,
        )
        return (rad_sum + rad, m2_sum + m2), None

    init = (
        jnp.zeros((S, n_pix), medium.tau_levels.dtype),
        jnp.zeros((S, n_pix), medium.tau_levels.dtype),
    )
    (rad_sum, m2_sum), _ = jax.lax.scan(
        chunk_body, init, jnp.arange(n_chunks)
    )
    return rad_sum / n_chunks, m2_sum / n_chunks


#: Maximum S * n_pix * spp paths per device dispatch for the one-shot
#: (structured-sampler) tracer; larger sample budgets are chunked so that
#: peak device memory stays bounded.
MAX_PATHS_PER_DISPATCH = 2**21


def render(
    scene: SceneArrays,
    sensor: SensorArrays,
    config: SceneConfig,
    spp: int,
    seed: int = 0,
    spp_chunk: int | None = None,
):
    """Render the full spectral batch for one distant-sensor bank.

    Returns dict with ``radiance`` [S, N], ``m2`` [S, N] (second moment of
    per-sample contributions), ``spp``.
    """
    if config.illumination_kind != "directional":
        raise NotImplementedError(
            "point-source (spot) illumination is supported by the canopy "
            "tracer only — distant radiometer banks cannot see a point "
            "source directly; use CanopyExperiment for lab scenes"
        )
    directions = jnp.asarray(sensor.directions)
    n_pix = directions.shape[0]
    S = scene.medium.tau_levels.shape[0]

    if config.sampler == "independent":
        # regenerative tracer: memory scales with lane count, not with the
        # sample budget — the whole budget runs in one dispatch (lanes
        # multiplex quota samples each; see trace_paths_regen)
        spp_chunk = spp
        n_chunks = 1
        traced = spp  # per-lane quotas split the budget exactly
    else:
        if spp_chunk is None:
            per_sample_paths = S * n_pix
            spp_chunk = max(
                1, MAX_PATHS_PER_DISPATCH // max(per_sample_paths, 1)
            )
        spp_chunk = min(spp_chunk, spp)
        # uniform chunks (sample budget rounds up to a chunk multiple)
        n_chunks = -(-spp // spp_chunk)
        traced = n_chunks * spp_chunk

    rad, m2 = _render_full(
        config,
        n_pix,
        spp_chunk,
        n_chunks,
        scene.medium,
        scene.surface,
        scene.illumination,
        directions,
        jnp.asarray(sensor.target),
        jnp.asarray(sensor.ray_offset),
        # uint32: SeedState emits full 32-bit seeds that overflow int32
        jnp.asarray(int(seed) & 0xFFFFFFFF, dtype=jnp.uint32),
        None
        if sensor.target_extent is None
        else jnp.asarray(sensor.target_extent),
    )
    return {"radiance": rad, "m2": m2, "spp": traced}
