"""Wavefront path tracer — polarized (Stokes/Mueller) transport,
plane-parallel geometry.

Polarized counterpart of :mod:`eradiate_tpu.ops.tracer` (reference:
``*_polarized`` Mitsuba variants + the ``stokes`` integrator wrapper,
SURVEY §2.1). Backward tracing accumulates the left Mueller product

    P_k = M_1 R_1 ... M_{k-1}            (4x4 per path)

so every NEE connection contributes ``P_k . R . M_phase(theta) . S_sun``
where ``S_sun = E [1,0,0,0]`` (unpolarized sun). Directions are sampled
from the *scalar* phase (exact importance sampling of the I-I component);
the Mueller weight divides by the scalar pdf, keeping every Stokes
component unbiased.

Reference-frame bookkeeping: each path stores the basis vector of the
current light segment; scattering frames use the in-plane ("parallel")
convention matching :func:`eradiate_tpu.ops.mueller.rayleigh_mueller`.
Output Stokes are referenced to the viewing direction's meridian basis
(the reference's ``meridian_align`` extension,
``scenes/integrators/_core.py:80-92``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .fastrng import bounce_uniforms, derive_keys, origin_uniforms

from .bsdf_ops import bsdf_sample_from_uniforms
from .bsdf_polarized import surface_mueller
from .medium import clamp_mu, take_1d, tau_at_z, z_at_tau
from .mueller import (
    default_basis,
    depolarizer,
    rayleigh_mueller,
    rotate_basis_angle,
    rotator,
)
from .phase_ops import phase_eval, phase_sample_from_uniforms
from .scene_state import SceneConfig

__all__ = ["render_polarized"]

#: f32 Stokes/Mueller contractions run at full f32: a backend's default
#: matmul precision may round operands (TF32 on recent NVIDIA GPUs).
_HI = jax.lax.Precision.HIGHEST


def _phase_mueller(phase_kinds, phase_params, phase_weights, layer, cos_theta):
    """Blend-weighted Mueller phase matrix [..., 4, 4] in scattering-plane
    frames. Polarized kinds contribute full matrices; scalar kinds
    contribute depolarizers (no polarization memory)."""
    total = jnp.zeros(cos_theta.shape + (4, 4))
    for c, kind in enumerate(phase_kinds):
        w = phase_weights[c, layer]
        params = phase_params[c]
        if kind == "rayleigh":
            m = rayleigh_mueller(cos_theta, params["depol"][layer])
        elif kind == "tab_polarized":
            m = _tab_polarized_mueller(params, cos_theta)
        else:
            from .phase_ops import _component_eval

            val = _component_eval(kind, params, layer, cos_theta)
            m = depolarizer(val)
        total = total + w[..., None, None] * m
    return total


def _tab_polarized_mueller(params, cos_theta):
    """Tabulated polarized phase matrix: components m11, m12, m22, m33,
    m34, m44 on the mu grid (reference ``tabphase_polarized``,
    ``scenes/phase/_tabulated.py:208-255``)."""
    mu = params["mu"]

    def interp(name):
        return jnp.interp(cos_theta, mu, params[name])

    m11 = interp("values")  # I-I component doubles as the scalar phase
    m12 = interp("m12")
    m22 = interp("m22")
    m33 = interp("m33")
    m34 = interp("m34")
    m44 = interp("m44")
    z = jnp.zeros_like(m11)
    return jnp.stack(
        [
            jnp.stack([m11, m12, z, z], axis=-1),
            jnp.stack([m12, m22, z, z], axis=-1),
            jnp.stack([z, z, m33, m34], axis=-1),
            jnp.stack([z, z, -m34, m44], axis=-1),
        ],
        axis=-2,
    )


def _scatter_frames(l_in, l_out):
    """In-plane bases (h_in, h_out) of the scattering plane spanned by the
    light propagation directions l_in -> l_out; degenerate (forward /
    backward) configurations fall back to an arbitrary perpendicular."""
    n = jnp.cross(l_in, l_out)
    nn = jnp.linalg.norm(n, axis=-1, keepdims=True)
    from .phase_ops import ortho_frame

    t1, _ = ortho_frame(l_in)
    n = jnp.where(nn > 1e-7, n / jnp.maximum(nn, 1e-12), t1)
    h_in = jnp.cross(n, l_in)
    h_in = h_in / jnp.maximum(jnp.linalg.norm(h_in, axis=-1, keepdims=True), 1e-12)
    h_out = jnp.cross(n, l_out)
    h_out = h_out / jnp.maximum(
        jnp.linalg.norm(h_out, axis=-1, keepdims=True), 1e-12
    )
    return h_in, h_out


def _make_bounce_polarized(config: SceneConfig, medium_row, surface_row, illum_row):
    """Per-bounce Mueller-transport transition closure shared by the
    one-shot and regenerative loops; see
    :func:`eradiate_tpu.ops.tracer._make_bounce` for the pattern."""
    z_levels = medium_row.z_levels
    tau_levels = medium_row.tau_levels
    tau_top = tau_levels[-1]
    z_bottom = z_levels[0]

    d_sun = illum_row.direction
    mu_sun = clamp_mu(-d_sun[2])
    w_sun = -d_sun
    E_sun = illum_row.irradiance

    def tau_z(z):
        return tau_at_z(z, z_levels, tau_levels)

    def sun_transmittance(z):
        return jnp.exp(-(tau_top - tau_z(z)) / mu_sun)

    def bounce(depth_b, z, xy, d, P, b, beta, keys):
        B = z.shape[0]
        # one batched threefry draw per bounce, SAME slot layout as the
        # scalar tracer (ops/tracer._make_bounce) so scalar/polarized runs
        # with the same seed trace identical sample paths
        U = bounce_uniforms(config.rng, keys, depth_b, 10)
        u_dist = U[:, 0]
        u_ph_sel, u_ph_cos, u_ph_phi = U[:, 3], U[:, 4:6], U[:, 6]
        u_srf = U[:, 7:9]
        u_rr = U[:, 9]

        mu = clamp_mu(d[:, 2])
        tau_here = tau_z(z)
        tau_exit = jnp.where(mu > 0.0, (tau_top - tau_here) / mu, tau_here / (-mu))
        tau_s = -jnp.log1p(-u_dist)
        collide = tau_s < tau_exit

        # lr_flight (see ops/tracer.py): detach the sampling geometry and
        # restore the medium's parameter dependence via smooth
        # likelihood-ratio weights — unbiased extinction tangents. The
        # z-space state here makes it direct: z is a fixed position, so
        # tau_z(z_col)/tau_here are the attached values already. All
        # corrections are primal-neutral (bit-identical rendering).
        _lr = bool(getattr(config, "lr_flight", False))
        sg = jax.lax.stop_gradient if _lr else (lambda x: x)
        tau_new = jnp.clip(sg(tau_here) + mu * tau_s, 0.0, sg(tau_top))
        z_col, layer = z_at_tau(tau_new, z_levels, sg(tau_levels))
        if _lr:
            tau_path = jnp.abs(tau_z(z_col) - tau_here) / jnp.abs(mu)
            dtau_col = take_1d(jnp.diff(tau_levels), layer)
            g_col = jnp.log(jnp.maximum(dtau_col, 1e-30)) - tau_path
            r_col = jnp.exp(g_col - sg(g_col))  # primal exactly 1.0
            r_bnd = jnp.exp(-(tau_exit - sg(tau_exit)))  # primal 1.0
        else:
            r_col = r_bnd = 1.0
        xy_col = xy + d[:, :2] * ((z_col - z) / mu)[:, None]
        albedo_col = take_1d(medium_row.albedo, layer)

        l_out = -d  # light leaves the vertex toward the sensor path

        # ---- NEE at the collision --------------------------------------
        cos_nee = jnp.sum(d_sun * l_out, axis=-1)
        h_in_nee, h_out_nee = _scatter_frames(
            jnp.broadcast_to(d_sun, d.shape), l_out
        )
        M_nee = jax.vmap(
            lambda l, c: _phase_mueller(
                config.phase_kinds,
                medium_row.phase_params,
                medium_row.phase_weights,
                l,
                c,
            )
        )(layer, cos_nee)
        alpha_out = rotate_basis_angle(l_out, h_out_nee, b)
        R_out = rotator(alpha_out)
        S_sun = jnp.zeros((B, 4)).at[:, 0].set(
            E_sun * sun_transmittance(z_col) * albedo_col * beta * r_col
        )
        S_col = jnp.einsum(
            "bij,bjk,bkl,bl->bi", P, R_out, M_nee, S_sun,
            precision=_HI,
        )

        # ---- sampled continuation --------------------------------------
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
        alpha_out_s = rotate_basis_angle(l_out, h_out_s, b)
        M_full = jnp.einsum(
            "bij,bjk->bik", rotator(alpha_out_s), M_s, precision=_HI
        ) / jnp.maximum(p_scalar, 1e-30)[:, None, None]
        P_col = jnp.einsum("bij,bjk->bik", P, M_full, precision=_HI)
        b_col = h_in_s
        beta_col = beta * albedo_col * r_col

        # ---- surface hit ------------------------------------------------
        # Mueller-general: polarized kinds (maignan, ocean_mishchenko) get
        # their full matrices; scalar kinds reduce exactly to the
        # depolarizer path (rotations leave (I,0,0,0) invariant).
        hit_surface = (~collide) & (mu < 0.0) & config.has_surface
        xy_surf = xy + d[:, :2] * ((z_bottom - z) / mu)[:, None]
        wo = -d
        T_sun_bottom = jnp.exp(-tau_top / mu_sun)

        # NEE: incident light propagates along d_sun, leaves along wo
        M_nee_srf = surface_mueller(
            config.surface_kind, surface_row.params, w_sun[None, :], wo, xy_surf
        )
        _, h_out_srf = _scatter_frames(jnp.broadcast_to(d_sun, d.shape), wo)
        R_out_srf = rotator(rotate_basis_angle(wo, h_out_srf, b))
        S_sun_srf = jnp.zeros((B, 4)).at[:, 0].set(
            beta * r_bnd * mu_sun * T_sun_bottom * E_sun
        )
        S_surf = jnp.einsum(
            "bij,bjk,bkl,bl->bi", P, R_out_srf, M_nee_srf, S_sun_srf,
            precision=_HI,
        )

        # sampled continuation: light would come from d_srf (propagation
        # -d_srf) and leave along wo
        d_srf, w_srf = bsdf_sample_from_uniforms(
            config.surface_kind, surface_row.params, wo, u_srf, xy_surf
        )
        M_cont = surface_mueller(
            config.surface_kind, surface_row.params, d_srf, wo, xy_surf
        )
        h_in_c, h_out_c = _scatter_frames(-d_srf, wo)
        R_out_c = rotator(rotate_basis_angle(wo, h_out_c, b))
        f_scalar = jnp.maximum(M_cont[:, 0, 0], 1e-30)
        P_surf = jnp.einsum(
            "bij,bjk,bkl->bil", P, R_out_c, M_cont / f_scalar[:, None, None],
            precision=_HI,
        )
        b_surf = h_in_c
        beta_surf = beta * r_bnd * w_srf

        # ---- combine ----------------------------------------------------
        S_add = jnp.where(
            collide[:, None],
            S_col,
            jnp.where(hit_surface[:, None], S_surf, 0.0),
        )
        z2 = jnp.where(collide, z_col, z_bottom)
        xy2 = jnp.where(collide[:, None], xy_col, xy_surf)
        d2 = jnp.where(collide[:, None], d_new, d_srf)
        P2 = jnp.where(
            collide[:, None, None],
            P_col,
            jnp.where(hit_surface[:, None, None], P_surf, P),
        )
        b2 = jnp.where(collide[:, None], b_col, b_surf)
        beta2 = jnp.where(
            collide, beta_col, jnp.where(hit_surface, beta_surf, 0.0)
        )
        alive2 = (collide | hit_surface) & (beta2 > 0.0)

        do_rr = depth_b >= config.rr_depth
        q = jnp.clip(beta2, 0.0, 0.95)
        survive = u_rr < q
        # RR reweighting applies ONCE, to beta: every contribution is
        # P @ ... @ S_in(beta ...), so scaling P as well would square the
        # 1/q factor (bias on RR-surviving deep paths)
        scale = jnp.where(do_rr & alive2 & survive, 1.0 / q, 1.0)
        beta2 = beta2 * scale
        alive2 = alive2 & jnp.where(do_rr, survive, True)

        return S_add, z2, xy2, d2, P2, b2, beta2, alive2

    return bounce


def trace_paths_polarized(
    config: SceneConfig,
    medium_row,
    surface_row,
    illum_row,
    init_z,
    init_xy,
    init_d,
    keys,
):
    """One-shot loop: per-path Stokes estimates [B, 4] in the meridian
    basis of the initial viewing direction."""
    B = init_z.shape[0]
    bounce = _make_bounce_polarized(config, medium_row, surface_row, illum_row)

    # initial light segment: toward the sensor; meridian basis
    b_init = default_basis(-init_d)
    P_init = jnp.broadcast_to(jnp.eye(4), (B, 4, 4))

    def body(carry):
        depth, z, xy, d, P, b, beta, S_acc, alive, keys = carry
        S_add, z2, xy2, d2, P2, b2, beta2, alive2 = bounce(
            jnp.full(B, depth), z, xy, d, P, b, beta, keys
        )
        S_acc = S_acc + jnp.where(alive[:, None], S_add, 0.0)
        alive = alive & alive2
        return (depth + 1, z2, xy2, d2, P2, b2, beta2, S_acc, alive, keys)

    def cond(carry):
        return (carry[0] < config.max_depth) & jnp.any(carry[8])

    init = (
        jnp.asarray(0),
        init_z,
        init_xy,
        init_d,
        P_init,
        b_init,
        jnp.ones(B, init_z.dtype),
        jnp.zeros((B, 4), init_z.dtype),
        jnp.ones(B, dtype=bool),
        keys,
    )
    final = jax.lax.while_loop(cond, body, init)
    return final[7]


def trace_paths_polarized_regen(
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
):
    """Regenerative Mueller-transport trace (see
    :func:`eradiate_tpu.ops.tracer.trace_paths_regen`): lanes re-seed a
    fresh (pixel, sample) path on death; keys depend only on the global
    sample id, so the sample set matches the one-shot loop exactly.
    Returns ``(S_sum [B, 4], m2_sum [B])`` summed over each lane's
    samples (m2 over the I component)."""
    B = init_z.shape[0]
    dtype = init_z.dtype
    bounce = _make_bounce_polarized(config, medium_row, surface_row, illum_row)
    b_init = default_basis(-init_d)
    eye4 = jnp.broadcast_to(jnp.eye(4, dtype=dtype), (B, 4, 4))
    row_keys_b = jnp.broadcast_to(row_key, (B,))

    def sample_key(s_local):
        return derive_keys(config.rng, row_keys_b, lane_first + s_local)

    def body(carry):
        (s_local, depth, z, xy, d, P, b, beta, S_cur, keys, done,
         S_sum, m2_sum) = carry

        S_add, z2, xy2, d2, P2, b2, beta2, alive2 = bounce(
            depth, z, xy, d, P, b, beta, keys
        )
        active = ~done
        S_cur = S_cur + jnp.where(active[:, None], S_add, 0.0)
        depth = depth + 1
        path_end = active & (~alive2 | (depth >= config.max_depth))

        S_sum = S_sum + jnp.where(path_end[:, None], S_cur, 0.0)
        m2_sum = m2_sum + jnp.where(path_end, S_cur[:, 0] ** 2, 0.0)
        s_local = s_local + path_end.astype(s_local.dtype)
        done = done | (s_local >= quota)

        regen = path_end & ~done
        keys = jnp.where(regen, sample_key(s_local), keys)
        z = jnp.where(regen, init_z, z2)
        xy = jnp.where(regen[:, None], init_xy, xy2)
        d = jnp.where(regen[:, None], init_d, d2)
        P = jnp.where(regen[:, None, None], eye4, P2)
        b = jnp.where(regen[:, None], b_init, b2)
        beta = jnp.where(regen, jnp.ones((), dtype), beta2)
        S_cur = jnp.where(path_end[:, None], 0.0, S_cur)
        depth = jnp.where(regen, 0, depth)

        return (s_local, depth, z, xy, d, P, b, beta, S_cur, keys, done,
                S_sum, m2_sum)

    def cond(carry):
        return jnp.any(~carry[10])

    init = (
        jnp.zeros(B, jnp.int32),
        jnp.zeros(B, jnp.int32),
        init_z,
        init_xy,
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


def _render_row_polarized(
    config, n_pix, spp, medium_row, surface_row, illum_row, directions, key,
    sample_offset=None, spp_stride=None,
):
    from .tracer import lane_partition

    lp, pix, slot, lane_first, quota = lane_partition(
        n_pix, spp, spp_stride=spp_stride, sample_offset=sample_offset
    )
    B = n_pix * lp
    z_top = medium_row.z_levels[-1]
    init_d = -directions[pix]
    S_sum, m2_sum = trace_paths_polarized_regen(
        config,
        medium_row,
        surface_row,
        illum_row,
        jnp.full(B, z_top),
        jnp.zeros((B, 2)),
        init_d,
        key,
        lane_first,
        quota,
    )
    stokes = jnp.sum(S_sum.reshape(n_pix, lp, 4), axis=1) / spp
    m2 = jnp.sum(m2_sum.reshape(n_pix, lp), axis=1) / spp
    return stokes, m2


def render_batch_polarized_impl(
    config, n_pix, spp, medium, surface, illum, directions, keys,
    sample_offset=None, spp_stride=None,
):
    from .scene_state import IlluminationArrays, MediumArrays, SurfaceArrays

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
        return _render_row_polarized(
            config, n_pix, spp, mr, sr, ir, directions, k,
            sample_offset=sample_offset, spp_stride=spp_stride,
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


_render_batch_polarized = jax.jit(render_batch_polarized_impl, static_argnums=(0, 1, 2))


def render_polarized(scene, sensor, config, spp, seed=0, spp_chunk=None):
    """Polarized render: returns ``stokes`` [S, N, 4] (meridian-aligned),
    ``radiance`` [S, N] (= I), ``m2`` of I, ``spp``.

    The regenerative loop bounds memory by lane count, so the whole budget
    runs in one dispatch unless ``spp_chunk`` streams it explicitly.
    """
    directions = jnp.asarray(sensor.directions)
    n_pix = directions.shape[0]
    S = scene.medium.tau_levels.shape[0]

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
        st, m2 = _render_batch_polarized(
            config, n_pix, n, scene.medium, scene.surface, scene.illumination,
            directions, chunk_keys,
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
