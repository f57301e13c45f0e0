"""Wavefront path tracer — canopy scenes (leaf clouds + ground +
optional 1D atmosphere), plane-parallel geometry.

JAX equivalent of the reference's ``path`` integrator over
disk-based discrete canopies and of the coupled canopy + atmosphere
scenes (``experiments/_canopy.py:21``, ``_canopy_atmosphere.py:47``;
BASELINE config 5). One loop iteration resolves the nearest of
{medium collision (closed-form free flight), leaf-disk hit (dense chunked
sweep, :mod:`eradiate_tpu.ops.canopy`), ground hit, escape}; next-event
estimation casts leaf-occlusion shadow rays and multiplies the closed-form
atmospheric sun transmittance.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .fastrng import bounce_uniforms, derive_keys, origin_uniforms

from .bsdf_ops import (
    bilambertian_eval,
    bilambertian_sample_from_uniforms,
    bsdf_eval,
    bsdf_sample_from_uniforms,
)
from .canopy import (
    LeafCloudArrays,
    leaf_bounds,
    leaf_nearest,
    leaf_occluded,
)
from .medium import clamp_mu, take_1d, tau_at_z, z_at_tau
from .phase_ops import ortho_frame, phase_eval, phase_sample_from_uniforms
from .scene_state import (
    IlluminationArrays,
    MediumArrays,
    SceneConfig,
    SensorArrays,
    SurfaceArrays,
)

__all__ = ["render_canopy"]


def _to_world(n, v):
    t1, t2 = ortho_frame(n)
    return t1 * v[..., 0:1] + t2 * v[..., 1:2] + n * v[..., 2:3]


def _to_local(n, v):
    t1, t2 = ortho_frame(n)
    return jnp.stack(
        [jnp.sum(t1 * v, -1), jnp.sum(t2 * v, -1), jnp.sum(n * v, -1)], axis=-1
    )


def _canopy_helpers(
    config, medium_row, leaf_row, leaves, illum_row, tris, tri_row
):
    """Shared closures (medium tau, emitter NEE terms) for the canopy
    loops."""
    z_levels = medium_row.z_levels
    tau_levels = medium_row.tau_levels
    tau_top = tau_levels[-1]
    z_bottom = z_levels[0]
    z_top = z_levels[-1]

    d_sun = illum_row.direction
    mu_sun = clamp_mu(-d_sun[2])
    w_sun = -d_sun
    E_sun = illum_row.irradiance

    def tau_z(z):
        return tau_at_z(z, z_levels, tau_levels)

    # sweep bounds (AABBs): computed ONCE per render here (trace time,
    # outside the path while_loop) and passed to every sweep call
    leaf_box = leaf_bounds(leaves)
    if tris is not None:
        from .mesh import tri_bounds

        tri_box = tri_bounds(tris)
    else:
        tri_box = None

    def sun_T(pos):
        z = pos[:, 2]
        T_atm = jnp.exp(-(tau_top - tau_z(z)) / mu_sun)
        occluded = leaf_occluded(
            pos, jnp.broadcast_to(w_sun, pos.shape), jnp.full(pos.shape[0], 1e6),
            leaves, leaf_box,
        )
        if tris is not None:
            from .mesh import tri_occluded

            occluded = occluded | tri_occluded(
                pos, jnp.broadcast_to(w_sun, pos.shape),
                jnp.full(pos.shape[0], 1e6), tris, tri_box,
            )
        return T_atm * jnp.where(occluded, 0.0, 1.0)

    spot = config.illumination_kind == "spot"

    def nee_dir(pos):
        """Direction toward the emitter [B, 3] (no visibility terms)."""
        if not spot:
            return jnp.broadcast_to(w_sun, pos.shape)
        v = illum_row.position[None, :] - pos
        return v / jnp.maximum(
            jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-9
        )

    def nee_at(pos):
        """Next-event estimation terms at vertex positions [B, 3]:
        (w_nee [B, 3] toward the emitter, effective irradiance E [B]
        including visibility, beam profile and transmittance)."""
        if not spot:
            w = jnp.broadcast_to(w_sun, pos.shape)
            return w, sun_T(pos) * E_sun
        v = illum_row.position[None, :] - pos
        r = jnp.linalg.norm(v, axis=-1)
        w_nee = v / jnp.maximum(r[:, None], 1e-9)
        # top-hat beam: inside the cone around the spot axis
        in_beam = (
            -jnp.sum(w_nee * illum_row.direction, axis=-1)
            >= illum_row.cos_cutoff
        )
        # exact 1D-medium transmittance along the finite segment
        z_spot = jnp.clip(illum_row.position[2], z_bottom, z_top)
        dtau = jnp.abs(tau_z(z_spot) - tau_z(pos[:, 2]))
        T_atm = jnp.exp(-dtau / jnp.maximum(jnp.abs(w_nee[:, 2]), 1e-6))
        occ = leaf_occluded(pos, w_nee, r, leaves, leaf_box)
        if tris is not None:
            from .mesh import tri_occluded

            occ = occ | tri_occluded(pos, w_nee, r, tris, tri_box)
        # intensity [W/sr/nm] / r^2 [km^2] -> irradiance [W/m^2/nm]
        E = illum_row.irradiance * 1e-6 / jnp.maximum(r * r, 1e-12)
        E = jnp.where(in_beam & ~occ, E * T_atm, 0.0)
        return w_nee, E

    return {
        "tau_z": tau_z,
        "sun_T": sun_T,
        "nee_dir": nee_dir,
        "nee_at": nee_at,
        "leaf_box": leaf_box,
        "tri_box": tri_box,
    }


def trace_paths_canopy(
    config: SceneConfig,
    medium_row,
    surface_row,
    leaf_row,  # dict: reflectance, transmittance (scalars per spectral row)
    leaves: LeafCloudArrays,
    illum_row,
    init_pos,  # [B, 3]
    init_d,
    keys,
    tris=None,  # TriangleMeshArrays | None: trunks / mesh canopy elements
    tri_row=None,  # dict: reflectance, transmittance (bilambertian)
):
    """One-shot loop: one sample per lane (reference implementation; the
    regenerative loop below is the production path)."""
    helpers = _canopy_helpers(
        config, medium_row, leaf_row, leaves, illum_row, tris, tri_row
    )
    B = init_pos.shape[0]
    eps = 1e-6

    bounce = _make_bounce_canopy(
        config, medium_row, surface_row, leaf_row, leaves, illum_row,
        tris, tri_row, helpers["tau_z"], helpers["nee_dir"],
        helpers["nee_at"], eps, leaf_box=helpers["leaf_box"],
        tri_box=helpers["tri_box"],
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


def _make_bounce_canopy(
    config, medium_row, surface_row, leaf_row, leaves, illum_row,
    tris, tri_row, tau_z, nee_dir, nee_at, eps, leaf_box=None,
    tri_box=None,
):
    """Per-bounce transition closure shared by the one-shot and
    regenerative canopy loops (see ops/tracer._make_bounce)."""
    z_levels = medium_row.z_levels
    tau_levels = medium_row.tau_levels
    tau_top = tau_levels[-1]
    z_bottom = z_levels[0]
    z_top = z_levels[-1]

    def bounce(depth_b, pos, d, beta, keys):
        B = pos.shape[0]
        # one batched threefry draw per bounce (see ops/tracer._make_bounce)
        U = bounce_uniforms(config.rng, keys, depth_b, 8)
        u_dist = U[:, 0]
        u_sel, u_cos, u_phi = U[:, 1], U[:, 2:4], U[:, 4]
        u_srf = U[:, 5:7]
        u_rr = U[:, 7]

        z = pos[:, 2]
        mu = clamp_mu(d[:, 2])
        tau_here = tau_z(z)
        tau_exit = jnp.where(mu > 0.0, (tau_top - tau_here) / mu, tau_here / (-mu))
        tau_s = -jnp.log1p(-u_dist)
        collide_med = tau_s < tau_exit

        tau_new = jnp.clip(tau_here + mu * tau_s, 0.0, tau_top)
        z_med, layer = z_at_tau(tau_new, z_levels, tau_levels)
        z_edge = jnp.where(mu > 0.0, z_top, z_bottom)
        t_med = jnp.where(collide_med, (z_med - z) / mu, (z_edge - z) / mu)

        # nearest scatterer (leaf disk or mesh triangle) within the segment
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
        event_ground = (~collide_med) & ~hit_scat & (mu < 0.0) & config.has_surface

        # ---- positions --------------------------------------------------
        pos_leaf = pos + d * t_leaf[:, None]
        pos_med = pos + d * t_med[:, None]
        t_ground = (z_bottom - z) / mu
        pos_ground = pos + d * t_ground[:, None]
        pos_ground = pos_ground.at[:, 2].set(z_bottom)

        # ---- shared NEE -----------------------------------------------
        # ONE occlusion sweep per bounce: each lane evaluates NEE only at
        # its actual event vertex (three separate nee_at calls each cost a
        # full [B x n_leaves] shadow sweep — the dominant canopy cost).
        # The leaf offset uses the emitter direction, which is
        # position-independent for the directional sun and varies
        # negligibly over the offset for spot sources.
        # leaf frame (needed for the off-surface shadow origin)
        to_front = -jnp.sign(jnp.sum(d * n_leaf, axis=-1))
        n_shade = n_leaf * to_front[:, None]
        w_nee_leaf_dir = nee_dir(pos_leaf)
        wi_leaf_sign = jnp.sign(
            jnp.sum(n_shade * w_nee_leaf_dir, axis=-1)
        )[:, None]
        # distance-scaled lift-off: pos + t d at t ~ 100 km (TOA camera
        # starts) rounds by ~ulp(t) ~ 1e-5 km in f32 — the hit can land
        # BELOW the surface it hit, and a fixed 1e-6 offset then leaves
        # the shadow origin self-occluded by its own triangle/disk
        # (found by the trunk-cap forest going black once the AABB exit
        # pad stopped masking the self-hit). 2.4e-7 = 2 f32 ulp.
        eps_lane = (eps + t_leaf * 2.4e-7)[:, None]
        pos_leaf_off = pos_leaf + n_shade * wi_leaf_sign * eps_lane
        pos_ground_off = pos_ground + jnp.asarray([0.0, 0.0, eps])
        pos_nee = jnp.where(
            event_leaf[:, None],
            pos_leaf_off,
            jnp.where(event_med[:, None], pos_med, pos_ground_off),
        )
        w_nee, E_nee = nee_at(pos_nee)

        # ---- medium collision ------------------------------------------
        albedo_col = take_1d(medium_row.albedo, layer)
        w_nee_med, E_med = w_nee, E_nee
        # incoming light propagation (-w_nee) scattered into -d
        cos_nee = jnp.sum(w_nee_med * d, axis=-1)
        p_nee = jax.vmap(
            lambda l, c: phase_eval(
                config.phase_kinds, medium_row.phase_params,
                medium_row.phase_weights, l, c,
            )
        )(layer, cos_nee)
        L_med = beta * albedo_col * p_nee * E_med
        d_med = jax.vmap(
            lambda l, dd, us, uc, up: phase_sample_from_uniforms(
                config.phase_kinds, medium_row.phase_params,
                medium_row.phase_weights, l, dd, us, uc, up,
            )
        )(layer, d, u_sel, u_cos, u_phi)
        beta_med = beta * albedo_col

        # ---- leaf interaction (bilambertian) ---------------------------
        # local frame (n_shade, computed above) oriented toward the
        # incident side
        wo_leaf = _to_local(n_shade, -d)
        wi_sun_leaf = _to_local(n_shade, w_nee)
        if tris is not None:
            # per-path optics: bilambertian either way (trunks have zero
            # transmittance via their tri_row values)
            lp = {
                "reflectance": jnp.where(
                    tri_first, tri_row["reflectance"], leaf_row["reflectance"]
                ),
                "transmittance": jnp.where(
                    tri_first, tri_row["transmittance"], leaf_row["transmittance"]
                ),
            }
        else:
            lp = {
                "reflectance": jnp.broadcast_to(leaf_row["reflectance"], (B,)),
                "transmittance": jnp.broadcast_to(leaf_row["transmittance"], (B,)),
            }
        f_leaf = bilambertian_eval(lp, wi_sun_leaf, wo_leaf)
        cos_sun_leaf = jnp.abs(jnp.sum(n_shade * w_nee, axis=-1))
        # E_nee was evaluated at pos_leaf_off (the shadow origin slightly
        # off the leaf on the emitter's side) for event_leaf lanes
        L_leaf = beta * f_leaf * cos_sun_leaf * E_nee
        # leaf sampling reuses the phase uniform slots (exclusive branches)
        d_leaf_local, w_leaf = jax.vmap(
            lambda r, t, w, us, uc: bilambertian_sample_from_uniforms(
                {"reflectance": r, "transmittance": t}, w, us, uc
            )
        )(lp["reflectance"], lp["transmittance"], wo_leaf, u_sel, u_cos)
        d_leaf = _to_world(n_shade, d_leaf_local)
        beta_leaf = beta * w_leaf
        pos_leaf_new = pos_leaf + d_leaf * eps_lane

        # ---- ground -----------------------------------------------------
        wo = -d
        w_nee_g, E_g = w_nee, E_nee
        f_g = bsdf_eval(
            config.surface_kind, surface_row.params, w_nee_g, wo,
            pos_ground[:, :2],
        )
        mu_nee_g = jnp.maximum(w_nee_g[:, 2], 0.0)
        L_ground = beta * f_g * mu_nee_g * E_g
        d_ground, w_g = bsdf_sample_from_uniforms(
            config.surface_kind, surface_row.params, wo, u_srf,
            pos_ground[:, :2],
        )
        beta_ground = beta * w_g

        # ---- combine ----------------------------------------------------
        L_add = jnp.where(
            event_leaf, L_leaf,
            jnp.where(event_med, L_med, jnp.where(event_ground, L_ground, 0.0)),
        )
        pos2 = jnp.where(
            event_leaf[:, None], pos_leaf_new,
            jnp.where(event_med[:, None], pos_med, pos_ground),
        )
        d2 = jnp.where(
            event_leaf[:, None], d_leaf,
            jnp.where(event_med[:, None], d_med, d_ground),
        )
        beta2 = jnp.where(
            event_leaf, beta_leaf,
            jnp.where(event_med, beta_med, jnp.where(event_ground, beta_ground, 0.0)),
        )
        interacted = event_leaf | event_med | event_ground
        alive2 = interacted & (beta2 > 0.0)

        do_rr = depth_b >= config.rr_depth
        q = jnp.clip(beta2, 0.0, 0.95)
        survive = u_rr < q
        beta2 = jnp.where(do_rr & alive2 & survive, beta2 / q, beta2)
        alive2 = alive2 & jnp.where(do_rr, survive, True)

        return L_add, pos2, d2, beta2, alive2

    return bounce


#: Bounces between spatial lane sorts in the canopy regen loop (0 = off).
#: Sorting lanes by the Morton code of their current position keeps ray
#: blocks spatially coherent, which a sweep that culls leaf chunks per ray
#: block needs (incoherent lanes defeat it: one stray ray per block
#: touches every chunk). The dense sweep culls nothing, so the sort's cost
#: against its benefit is still to be measured on the GPU.
#: Override with ERADIATE_CANOPY_SORT=<n>.
CANOPY_SORT_EVERY = 1


def _sort_interval() -> int:
    import os

    v = os.environ.get("ERADIATE_CANOPY_SORT")
    return int(v) if v is not None else CANOPY_SORT_EVERY


def _morton_u32(pos, lo, hi):
    """7-bit/axis Morton code of positions [B, 3] within [lo, hi]."""
    span = jnp.maximum(hi - lo, 1e-12)
    q = jnp.clip((pos - lo) / span * 127.0, 0.0, 127.0).astype(jnp.uint32)
    code = jnp.zeros(pos.shape[0], jnp.uint32)
    for b in range(7):
        for ax in range(3):
            code = code | (
                ((q[:, ax] >> jnp.uint32(b)) & jnp.uint32(1))
                << jnp.uint32(3 * b + ax)
            )
    return code


def trace_paths_canopy_regen(
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
    """Regenerative canopy trace (see ops/tracer.trace_paths_regen):
    lanes re-seed a fresh (pixel, sample) path on death; ``ext`` [B, 2]
    jitters the xy origin per sample (footprint rectangle targets).
    Returns (L_sum, m2_sum) per lane.

    When ``CANOPY_SORT_EVERY`` > 0 the loop periodically permutes ALL lane
    state by the Morton code of the current position (done lanes parked at
    TOA pointing up, outside the leaf AABB). Keys travel
    with their lane, so per-sample paths are identical to the unsorted
    loop; only the f32 summation grouping changes. The final sums are
    scattered back to original lane order.
    """
    # reuse the closure setup of the one-shot entrypoint
    helpers = _canopy_helpers(
        config, medium_row, leaf_row, leaves, illum_row, tris, tri_row
    )
    bounce = _make_bounce_canopy(
        config, medium_row, surface_row, leaf_row, leaves, illum_row,
        tris, tri_row, helpers["tau_z"], helpers["nee_dir"],
        helpers["nee_at"], 1e-6, leaf_box=helpers["leaf_box"],
        tri_box=helpers["tri_box"],
    )
    B = init_pos.shape[0]
    dtype = init_pos.dtype
    z_top = medium_row.z_levels[-1]
    sort_every = _sort_interval()
    # scene bounds for the sort key: the leaf AABB plus the column above it
    box_lo, box_hi = helpers["leaf_box"]

    def sample_key(lane_first, s_local):
        return derive_keys(
            config.rng, jnp.broadcast_to(row_key, (B,)), lane_first + s_local
        )

    def origin(keys, init_pos, ext_l):
        if ext is None:
            return init_pos
        u = origin_uniforms(config.rng, keys, 2, dtype=dtype)
        jit = (u - 0.5) * ext_l
        return init_pos + jnp.concatenate(
            [jit, jnp.zeros((B, 1), dtype)], axis=-1
        )

    def body(carry):
        (it, s_local, depth, pos, d, beta, L_cur, keys, done,
         L_sum, m2_sum, lane_first_l, quota_l, init_pos_l, init_d_l,
         ext_l, orig) = carry

        L_add, pos2, d2, beta2, alive2 = bounce(depth, pos, d, beta, keys)
        active = ~done
        L_cur = L_cur + jnp.where(active, L_add, 0.0)
        depth = depth + 1
        path_end = active & (~alive2 | (depth >= config.max_depth))

        L_sum = L_sum + jnp.where(path_end, L_cur, 0.0)
        m2_sum = m2_sum + jnp.where(path_end, L_cur * L_cur, 0.0)
        s_local = s_local + path_end.astype(s_local.dtype)
        done = done | (s_local >= quota_l)

        regen = path_end & ~done
        keys_new = sample_key(lane_first_l, s_local)
        keys = jnp.where(regen, keys_new, keys)
        pos = jnp.where(
            regen[:, None], origin(keys_new, init_pos_l, ext_l), pos2
        )
        d = jnp.where(regen[:, None], init_d_l, d2)
        beta = jnp.where(regen, jnp.ones((), dtype), beta2)
        L_cur = jnp.where(path_end, 0.0, L_cur)
        depth = jnp.where(regen, 0, depth)

        # park done lanes at TOA pointing up: valid geometry with zero AABB
        # overlap, so their sweeps start with a zero flight cap
        park = jnp.stack(
            [jnp.zeros(B, dtype), jnp.zeros(B, dtype),
             jnp.full(B, z_top, dtype)], axis=-1
        )
        up = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], dtype), (B, 3))
        pos = jnp.where(done[:, None], park, pos)
        d = jnp.where(done[:, None], up, d)

        state = (s_local, depth, pos, d, beta, L_cur, keys, done,
                 L_sum, m2_sum, lane_first_l, quota_l, init_pos_l,
                 init_d_l, ext_l, orig)
        if sort_every > 0:
            def do_sort(st):
                code = _morton_u32(st[2], box_lo, box_hi)
                # done lanes to the very end
                code = jnp.where(st[7], jnp.uint32(0xFFFFFFFF), code)
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
        return jnp.any(~carry[8])

    lane_ext = (
        jnp.zeros((B, 2), dtype) if ext is None else jnp.asarray(ext)
    )
    keys0 = sample_key(lane_first, jnp.zeros(B, jnp.int32))
    init = (
        jnp.asarray(0),
        jnp.zeros(B, jnp.int32),
        jnp.zeros(B, jnp.int32),
        origin(keys0, init_pos, lane_ext if ext is not None else None)
        if ext is not None
        else init_pos,
        init_d,
        jnp.ones(B, dtype),
        jnp.zeros(B, dtype),
        keys0,
        jnp.zeros(B, dtype=bool),
        jnp.zeros(B, dtype),
        jnp.zeros(B, dtype),
        jnp.asarray(lane_first),
        jnp.broadcast_to(jnp.asarray(quota), (B,)),
        init_pos,
        init_d,
        lane_ext,
        jnp.arange(B, dtype=jnp.int32),
    )
    final = jax.lax.while_loop(cond, body, init)
    L_sum, m2_sum, orig = final[9], final[10], final[16]
    # undo the in-loop permutations: scatter sums back to original lanes
    L_out = jnp.zeros(B, dtype).at[orig].set(L_sum)
    m2_out = jnp.zeros(B, dtype).at[orig].set(m2_sum)
    return L_out, m2_out


def _render_row_canopy(
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
    # start at TOA on the line through the target, unless ray_offset is
    # finite (camera/in-scene sensors: start at target + ray_offset * w_v)
    t_up = jnp.where(
        jnp.isnan(ray_offset),
        (z_top - tgt[:, 2]) / jnp.maximum(w_v[:, 2], 1e-6),
        ray_offset,
    )
    init_pos = tgt + w_v * t_up[:, None]
    init_d = -w_v
    L_sum, m2_sum = trace_paths_canopy_regen(
        config, medium_row, surface_row, leaf_row, leaves, illum_row,
        init_pos, init_d, key, lane_first, quota, ext=ext,
        tris=tris, tri_row=tri_row,
    )
    radiance = jnp.sum(L_sum.reshape(n_pix, lp), axis=1) / spp
    m2 = jnp.sum(m2_sum.reshape(n_pix, lp), axis=1) / spp
    return radiance, m2


def render_batch_canopy_impl(
    config, n_pix, spp, medium, surface, leaf_params, leaves, illum,
    directions, target, ray_offset, keys, tris=None, tri_params=None,
    target_extent=None, sample_offset=None, spp_stride=None,
):
    # lax.map, not vmap: vmapping the while_loop defeats XLA's fusion of
    # the masked table lookups (see ops/tracer.render_batch_impl)
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
        return _render_row_canopy(
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


_render_batch_canopy = jax.jit(render_batch_canopy_impl, static_argnums=(0, 1, 2))


def render_canopy(
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
    """Render a canopy (+ optional atmosphere) scene.

    ``scene``: SceneArrays (medium may be zero-extinction for pure canopy
    scenes); ``leaf_params``: {"reflectance": [S], "transmittance": [S]}.
    ``tris``/``tri_params``: optional triangle soup (tree trunks, mesh
    canopy elements) with bilambertian optics.
    """
    from .tracer import MAX_PATHS_PER_DISPATCH

    directions = jnp.asarray(sensor.directions)
    target = jnp.asarray(sensor.target)
    ray_offset = jnp.asarray(sensor.ray_offset)
    n_pix = directions.shape[0]
    S = scene.medium.tau_levels.shape[0]

    if spp_chunk is None:
        # leaf sweeps make per-path work heavier; keep dispatches smaller
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

    rad_sum = jnp.zeros((S, n_pix))
    m2_sum = jnp.zeros((S, n_pix))
    traced = 0
    for chunk_id, n in enumerate(chunks):
        chunk_keys = jax.vmap(jax.random.fold_in)(row_keys, jnp.full(S, chunk_id))
        rad, m2 = _render_batch_canopy(
            config, n_pix, n, scene.medium, scene.surface, leaf_params, leaves,
            scene.illumination, directions, target, ray_offset, chunk_keys,
            tris, tri_params,
            None
            if sensor.target_extent is None
            else jnp.asarray(sensor.target_extent),
        )
        rad_sum = rad_sum + rad * n
        m2_sum = m2_sum + m2 * n
        traced += n

    return {"radiance": rad_sum / traced, "m2": m2_sum / traced, "spp": traced}
