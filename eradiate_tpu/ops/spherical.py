"""Spherical-shell geometry primitives.

JAX replacement for the reference's ``sphericalcoordsvolume`` medium
remap + curved-shell traversal (SURVEY §2.1; ``scenes/atmosphere/_core.py:
689-724``). The atmosphere is a set of concentric shells with
piecewise-constant extinction. Two ingredients:

- **Closed-form slant optical depth**: along a straight ray with impact
  parameter b, the path length inside the radius interval [ra, rb] is
  ``sqrt(rb^2 - b^2) - sqrt(ra^2 - b^2)``, so the slant optical depth to
  the sun is an L-term weighted sum — precomputed as a (altitude x local
  cosine) **Chapman-style table** per spectral index, contracted as a
  full-f32 [L+1*M, L] x [L, S] matmul, then bilinearly interpolated by the
  tracer at every NEE event.
- **Ray/sphere stepping** and the **exact free-flight sampler**
  (:func:`shell_flight`) that replaces the ``heterogeneous`` medium's
  delta tracking.

All radii in km; the planet center is the coordinate origin.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "ray_sphere_intersect",
    "slant_path_matrix",
    "slant_tau_exact",
    "sun_mu_grid",
    "sun_mu_grid_warped",
    "sun_tau_fetch",
    "sun_tau_fetch_fast",
    "sun_tau_table",
    "sun_tau_table_grid",
    "lookup_sun_tau",
]

#: Optical depth treated as total blockage (ground shadow).
TAU_BLOCKED = 1e10


def ray_sphere_intersect(p, d, radius):
    """Distances to a sphere |x| = radius along x = p + t d.

    Returns (t_near, t_far, hit): roots sorted ascending; ``hit`` False if
    no real intersection. Vectorized over leading axes of p/d.
    """
    b = jnp.sum(p * d, axis=-1)
    c = jnp.sum(p * p, axis=-1) - radius * radius
    disc = b * b - c
    hit = disc >= 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    return -b - sq, -b + sq, hit


def _seg(b2, ra, rb):
    """Path length between radii ra <= rb at squared impact parameter b2.

    Callers guarantee ra >= b (shell bounds are clamped to the tangent
    radius), so the cancellation-stable form

        sqrt(rb^2 - b^2) - sqrt(ra^2 - b^2) = (rb - ra)(rb + ra) / (fa + fb)

    applies: the naive difference of two ~6400 km sqrts loses ~3 digits in
    f32 (0.1% tau error on 1 km shells); this form is exact for vertical
    rays and ~1e-7 relative elsewhere.
    """
    fa = jnp.sqrt(jnp.maximum(ra * ra - b2, 0.0))
    fb = jnp.sqrt(jnp.maximum(rb * rb - b2, 0.0))
    num = jnp.maximum(rb - ra, 0.0) * (rb + ra)
    den = fa + fb
    return jnp.where(den > 0.0, num / jnp.maximum(den, 1e-30), 0.0)


def slant_path_matrix(radii, r0_grid, mu_grid, r_ground=None):
    """Geometric path-length matrix D[i, j, k]: length of the path from
    radius ``r0_grid[i]`` with local direction cosine ``mu_grid[j]``
    (toward zenith = +1) inside shell k, until exit at the top radius.

    Rays with a tangent radius below ``r_ground`` are blocked (the caller
    adds TAU_BLOCKED). Returns (D, blocked) with D [I, J, L], blocked
    [I, J] bool.
    """
    radii = jnp.asarray(radii)
    r_top = radii[-1]
    r_ground = radii[0] if r_ground is None else r_ground
    r0 = jnp.asarray(r0_grid)[:, None]  # [I, 1]
    mu = jnp.asarray(mu_grid)[None, :]  # [1, J]

    sin2 = jnp.clip(1.0 - mu * mu, 0.0, 1.0)
    b2 = (r0 * r0) * sin2  # [I, J]
    b = jnp.sqrt(b2)

    descending = mu < 0.0
    # STRICT inequality: at mu = -1 the impact parameter is exactly 0,
    # and a table built with r_ground = 0 ("planet absent"; blockage
    # applied exactly by the caller) must NOT mark that column blocked —
    # TAU_BLOCKED there poisons every bilinear fetch with mu near -1
    # (round-5 fix; grazing b == r_ground is measure-zero either way)
    blocked = descending & (b < r_ground)

    lo = radii[:-1][None, None, :]  # [1, 1, L]
    hi = radii[1:][None, None, :]
    b2e = b2[..., None]
    r0e = jnp.broadcast_to(r0[..., None], b2e.shape)

    # ascending part: radii in [max(r0, b), r_top]
    asc_lo = jnp.maximum(lo, jnp.maximum(r0e, jnp.sqrt(b2e)))
    asc_hi = hi
    up = _seg(b2e, jnp.minimum(asc_lo, asc_hi), asc_hi)

    # descending prefix (mu < 0): radii in [b, r0] traversed once more
    des_lo = jnp.maximum(lo, jnp.sqrt(b2e))
    des_hi = jnp.minimum(hi, r0e)
    down = _seg(b2e, jnp.minimum(des_lo, des_hi), des_hi)
    # ascending part for mu<0 covers [b, r_top] instead of [r0, r_top]
    asc_lo_tan = jnp.maximum(lo, jnp.sqrt(b2e))
    up_tan = _seg(b2e, jnp.minimum(asc_lo_tan, hi), hi)

    D = jnp.where(descending[..., None], down + up_tan, up)
    return D, blocked


import functools


@functools.partial(jax.jit, static_argnames=("chunk",))
def sun_tau_table(sigma_t, radii, mu_grid, r_ground=None, chunk=128):
    """Slant optical depth table tau[s, i, j] from level radius i toward
    the sun at local cosine mu_grid[j].

    sigma_t: [S, L]; radii: [L+1]. Chunked over the altitude axis to bound
    the [I, J, L] geometric tensor; the contraction over shells is one
    full-f32 matmul per chunk. Jitted: eagerly, each op of the chunk loop
    would be a separate dispatch.
    """
    radii = jnp.asarray(radii)
    I = radii.shape[0]
    n_chunks = -(-I // chunk)
    pad = n_chunks * chunk - I
    r0_padded = jnp.concatenate([radii, jnp.full(pad, radii[-1])]) if pad else radii
    r0_chunks = r0_padded.reshape(n_chunks, chunk)

    def per_chunk(r0c):
        D, blocked = slant_path_matrix(radii, r0c, mu_grid, r_ground)
        # [chunk, J, L] x [S, L] -> [S, chunk, J]
        tau = jnp.einsum(
            "ijl,sl->sij", D, sigma_t, precision=jax.lax.Precision.HIGHEST
        )
        tau = jnp.where(blocked[None, :, :], TAU_BLOCKED, tau)
        return tau

    taus = jax.lax.map(per_chunk, r0_chunks)  # [n_chunks, S, chunk, J]
    taus = jnp.moveaxis(taus, 0, 1).reshape(
        sigma_t.shape[0], n_chunks * chunk, mu_grid.shape[0]
    )
    return taus[:, :I, :]


def slant_tau_exact(p, w, radii, sigma, r_ground=None):
    """Exact slant optical depth from points ``p`` toward unit direction
    ``w`` through concentric shells (no table, no interpolation).

    Same geometry as :func:`slant_path_matrix`, vectorized over a path
    batch instead of a (radius, cosine) grid: per shell the traversed
    length is a difference of ``sqrt(r^2 - b^2)`` terms at the ray's
    squared impact parameter ``b^2``, so the whole computation is ~10
    fused elementwise passes over [B, L] plus one reduction, with no
    [L+1, M] table precompute.

    p: [B, 3] (planet-centered km); w: [3] unit; sigma: [L] per-shell
    extinction; radii: [L+1]. Descending rays whose tangent radius dips
    below ``r_ground`` return TAU_BLOCKED (ground shadow).
    """
    radii = jnp.asarray(radii)
    r_ground = radii[0] if r_ground is None else r_ground
    r2 = jnp.sum(p * p, axis=-1)
    r = jnp.sqrt(r2)
    mu = jnp.sum(p * w, axis=-1) / jnp.maximum(r, 1e-12)
    # b² from the cross product: cancellation-free where r²(1 - mu²)
    # loses all digits for near-radial rays at planet-scale radii
    b2 = jnp.sum(jnp.cross(p, jnp.broadcast_to(w, p.shape)) ** 2, axis=-1)
    b = jnp.sqrt(b2)
    descending = mu < 0.0
    # strict: b == r_ground is a grazing tangent (see slant_path_matrix)
    blocked = descending & (b < r_ground)

    lo = radii[:-1][None, :]  # [1, L]
    hi = radii[1:][None, :]
    b2e = b2[:, None]
    re = r[:, None]
    be = b[:, None]

    # ascending part: shells in [max(r, b), r_top]
    asc_lo = jnp.maximum(lo, jnp.maximum(re, be))
    up = _seg(b2e, jnp.minimum(asc_lo, hi), hi)

    # descending prefix (mu < 0): shells in [b, r] traversed once more,
    # and the ascending part then covers [b, r_top]
    des_lo = jnp.maximum(lo, be)
    des_hi = jnp.minimum(hi, re)
    down = _seg(b2e, jnp.minimum(des_lo, des_hi), des_hi)
    up_tan = _seg(b2e, jnp.minimum(des_lo, hi), hi)

    D = jnp.where(descending[:, None], down + up_tan, up)  # [B, L]
    tau = jnp.sum(D * sigma, axis=-1)
    return jnp.where(blocked, TAU_BLOCKED, tau)


def shell_event(p, d, t_max, radii, sigma, tau_s, w_sun):
    """Per-event transition: exact free flight AND the sun slant optical
    depth at the resulting event point p' = p + t d.

    Returns (collide [B] bool, t_col [B], layer [B] int32, tau_sun [B]).
    """
    collide, t_col, layer = shell_flight(p, d, t_max, radii, sigma, tau_s)
    t_step = jnp.where(collide, t_col, t_max)
    p_new = p + d * t_step[:, None]
    tau_sun = slant_tau_exact(p_new, w_sun, radii, sigma)
    return collide, t_col, layer, tau_sun


def shell_flight_lr(p, d, t_max, radii, sigma, tau_s):
    """Likelihood-ratio variant of :func:`shell_flight` (sensitivity
    path): samples from the detached (stop_gradient) medium and returns
    the attached-medium ratio ingredients; primal values equal
    :func:`shell_flight` bit for bit.

    Returns (collide, t_col, layer, g_col, tau_max_att) where
    ``exp(g_col - sg(g_col))`` is the collision-branch importance weight
    and ``exp(-(tau_max_att - sg(tau_max_att)))`` the boundary-branch
    one.
    """
    return shell_flight(
        p, d, t_max, radii, jax.lax.stop_gradient(sigma), tau_s,
        sigma_attached=sigma,
    )


def shell_flight(p, d, t_max, radii, sigma, tau_s, sigma_attached=None):
    """Exact free-flight sampling through concentric shells.

    The spherical analog of the plane-parallel closed-form sampler
    (``ops/medium.z_at_tau``): with piecewise-constant extinction per
    shell, the cumulative optical depth along a straight ray is piecewise
    linear in the path coordinate, so collisions invert it exactly — no
    null-collision/majorant loop, deterministic transmittance (zero
    tracking variance). Replaces the reference's stock ``heterogeneous``
    delta-tracking medium with the exactness its ``piecewise`` medium has
    in plane-parallel geometry (SURVEY §2.1).

    Parametrize the ray by the signed coordinate x along ``d`` with origin
    at the closest approach to the planet center: r(x) = sqrt(b^2 + x^2).
    Shell k is traversed for |x| in [X(r_k), X(r_{k+1})] with
    X(r) = sqrt(max(r^2 - b^2, 0)); the 2L+1 candidate segments (L on the
    descending leg, a below-tangent gap, L ascending) have constant sigma,
    so cum-tau at the segment ends is one cumsum and the inversion is a
    dense table search.

    p: [B, 3]; d: [B, 3] unit; t_max: [B] flight cap (ground/top exit);
    radii: [L+1]; sigma: [L]; tau_s: [B] sampled exponential depths.
    Returns (collide [B] bool, t_col [B], layer [B] int32) with
    t_col <= t_max at collisions. With ``sigma_attached`` (the
    likelihood-ratio path, :func:`shell_flight_lr`) two more outputs
    follow: the collision log-density and the boundary depth under the
    attached medium.
    """
    Lp1 = radii.shape[0]
    L = Lp1 - 1
    dtype = radii.dtype
    x0 = jnp.sum(p * d, axis=-1)  # [B]
    # b² from the cross product (cancellation-free; see slant_tau_exact)
    b2 = jnp.sum(jnp.cross(p, d) ** 2, axis=-1)
    X = jnp.sqrt(jnp.maximum(radii[None, :] ** 2 - b2[:, None], 0.0))  # [B, L+1]

    # G[b, k] = tau from the tangent point to level k along one leg:
    # prefix sums of per-shell slant depths c = sigma * dX, as a
    # triangular one-hot matmul (hi/lo bf16 split with f32 accumulation
    # recovers ~f32 accuracy; the 0/1 triangle is exact in bf16). Chosen
    # over a per-lane cumsum on the previous accelerator; the GPU choice
    # is an open item (ROADMAP, Speed).
    c = sigma[None, :] * jnp.diff(X, axis=1)  # [B, L]
    tri = (
        jnp.arange(L, dtype=jnp.int32)[:, None]
        < jnp.arange(Lp1, dtype=jnp.int32)[None, :]
    ).astype(jnp.bfloat16)  # [L, L+1]
    c_hi = c.astype(jnp.bfloat16)
    c_lo = (c - c_hi.astype(dtype)).astype(jnp.bfloat16)
    G = jnp.matmul(
        c_hi, tri, preferred_element_type=dtype
    ) + jnp.matmul(c_lo, tri, preferred_element_type=dtype)  # [B, L+1]

    def G_at(y):
        """Interpolate G(|x|) and return (value, shell index)."""
        k = jnp.clip(
            jnp.sum((X <= y[:, None]).astype(jnp.int32), axis=1) - 1, 0, L - 1
        )
        iota = jnp.arange(Lp1, dtype=jnp.int32)
        m = iota[None, :] == k[:, None]
        Gk = jnp.sum(jnp.where(m, G, 0.0), axis=1)
        Xk = jnp.sum(jnp.where(m, X, 0.0), axis=1)
        sig_k = jnp.sum(
            jnp.where(m[:, :L], sigma[None, :], 0.0), axis=1
        )
        return Gk + sig_k * jnp.maximum(y - Xk, 0.0), k

    def G_inv(v):
        """Invert G: y with G(y) = v; returns (y, shell index)."""
        k = jnp.clip(
            jnp.sum((G <= v[:, None]).astype(jnp.int32), axis=1) - 1, 0, L - 1
        )
        iota = jnp.arange(Lp1, dtype=jnp.int32)
        m = iota[None, :] == k[:, None]
        Gk = jnp.sum(jnp.where(m, G, 0.0), axis=1)
        Xk = jnp.sum(jnp.where(m, X, 0.0), axis=1)
        sig_k = jnp.sum(
            jnp.where(m[:, :L], sigma[None, :], 0.0), axis=1
        )
        y = Xk + (v - Gk) / jnp.maximum(sig_k, 1e-30)
        return y, k

    desc = x0 < 0.0
    A, _ = G_at(jnp.abs(x0))  # tau tangent -> start position
    x_max = x0 + t_max
    Gm, _ = G_at(jnp.abs(x_max))
    tau_max = jnp.where(
        desc,
        jnp.where(x_max < 0.0, A - Gm, A + Gm),
        Gm - A,
    )
    collide = tau_s < jnp.maximum(tau_max, 0.0)

    # inversion: descending lanes spend up to A before the tangent, then
    # continue on the ascending leg; ascending lanes invert directly
    on_desc = desc & (tau_s < A)
    v = jnp.where(on_desc, A - tau_s, jnp.where(desc, tau_s - A, A + tau_s))
    y, layer = G_inv(v)
    x_col = jnp.where(on_desc, -y, y)
    t_col = jnp.clip(x_col - x0, 0.0, t_max)

    if sigma_attached is None:
        return collide, t_col, layer

    # --- likelihood-ratio extras (sensitivity path only) ----------------
    # Attached-medium path depths AT THE FIXED sampled geometry: the
    # shell geometry X is theta-free, so a second prefix with the
    # attached sigma evaluated at the detached coordinates (|x0|, |x_max|,
    # y) gives tau_path/tau_max under the attached medium. Combined with
    # the attached sigma at the detached collision layer these form the
    # smooth per-segment importance weights of the likelihood-ratio
    # flight estimator (see ops/tracer.py).
    sig_a = sigma_attached
    c_a = sig_a[None, :] * jnp.diff(X, axis=1)
    ca_hi = c_a.astype(jnp.bfloat16)
    ca_lo = (c_a - ca_hi.astype(dtype)).astype(jnp.bfloat16)
    G_a = jnp.matmul(
        ca_hi, tri, preferred_element_type=dtype
    ) + jnp.matmul(ca_lo, tri, preferred_element_type=dtype)

    def G_a_eval(yy):
        k = jnp.clip(
            jnp.sum((X <= yy[:, None]).astype(jnp.int32), axis=1) - 1,
            0,
            L - 1,
        )
        iota = jnp.arange(Lp1, dtype=jnp.int32)
        m = iota[None, :] == k[:, None]
        Gk = jnp.sum(jnp.where(m, G_a, 0.0), axis=1)
        Xk = jnp.sum(jnp.where(m, X, 0.0), axis=1)
        sk = jnp.sum(jnp.where(m[:, :L], sig_a[None, :], 0.0), axis=1)
        return Gk + sk * jnp.maximum(yy - Xk, 0.0)

    A_a = G_a_eval(jnp.abs(x0))
    Gm_a = G_a_eval(jnp.abs(x_max))
    tau_max_att = jnp.where(
        desc, jnp.where(x_max < 0.0, A_a - Gm_a, A_a + Gm_a), Gm_a - A_a
    )
    Gy_a = G_a_eval(y)
    tau_path_att = jnp.where(
        on_desc, A_a - Gy_a, jnp.where(desc, A_a + Gy_a, Gy_a - A_a)
    )
    iota_l = jnp.arange(L, dtype=jnp.int32)
    sig_at = jnp.sum(
        jnp.where(iota_l[None, :] == layer[:, None], sig_a[None, :], 0.0),
        axis=1,
    )
    g_col = jnp.log(jnp.maximum(sig_at, 1e-30)) - tau_path_att
    return collide, t_col, layer, g_col, tau_max_att


def sun_mu_grid_warped(M: int = 128, mu_c: float = -0.12, s: float = 0.08):
    """Horizon-concentrated local-cosine grid with a CLOSED-FORM inverse.

    ``mu(t) = mu_c + s*sinh(a + t*(b-a))`` with ``a = asinh((-1-mu_c)/s)``,
    ``b = asinh((1-mu_c)/s)``: node density peaks around ``mu_c`` (the
    terminator band, see :func:`sun_mu_grid`) and the index of any mu is
    pure arithmetic — ``t = (asinh((mu-mu_c)/s) - a) / (b - a)`` — so the
    per-event fetch needs NO [B, M] compare-and-sum to locate its cell
    (the round-5 c4 profile put those index reductions at ~13% of device
    time). At M=128 the center spacing is ~0.004 in mu and the edge
    spacing ~0.057, matching the piecewise grid it replaces.

    Returns (mu_grid [M] float64, (mu_c, s, a, b)).
    """
    a = float(np.arcsinh((-1.0 - mu_c) / s))
    b = float(np.arcsinh((1.0 - mu_c) / s))
    t = np.linspace(0.0, 1.0, M)
    mu = mu_c + s * np.sinh(a + t * (b - a))
    mu[0], mu[-1] = -1.0, 1.0
    return mu, (mu_c, s, a, b)


def sun_tau_table_grid(sigma_t, radii, r0_grid, mu_grid, r_ground=None, chunk=128):
    """Slant-tau table on an EXPLICIT (r0_grid, mu_grid): like
    :func:`sun_tau_table` but decoupling the altitude sample points from
    the shell boundaries — a uniform r0 grid makes the fetch index
    arithmetic (no searchsorted / compare-sum). Returns [S, I, J]."""
    radii = jnp.asarray(radii)
    r0_grid = jnp.asarray(r0_grid)
    I = r0_grid.shape[0]
    n_chunks = -(-I // chunk)
    pad = n_chunks * chunk - I
    r0_padded = (
        jnp.concatenate([r0_grid, jnp.full(pad, r0_grid[-1])]) if pad else r0_grid
    )
    r0_chunks = r0_padded.reshape(n_chunks, chunk)

    def per_chunk(r0c):
        D, blocked = slant_path_matrix(radii, r0c, mu_grid, r_ground)
        tau = jnp.einsum(
            "ijl,sl->sij", D, sigma_t, precision=jax.lax.Precision.HIGHEST
        )
        tau = jnp.where(blocked[None, :, :], TAU_BLOCKED, tau)
        return tau

    taus = jax.lax.map(per_chunk, r0_chunks)
    taus = jnp.moveaxis(taus, 0, 1).reshape(
        sigma_t.shape[0], n_chunks * chunk, mu_grid.shape[0]
    )
    return taus[:, :I, :]


def sun_tau_fetch_fast(table, r_grid, mu_warp, r, mu):
    """Bilinear sun-tau fetch with ARITHMETIC cell location.

    Rewrite of :func:`sun_tau_fetch` driven by a c4 profile on the
    previous accelerator (the three hi/lo matmuls over the [233, 226]
    table and the compare-sum index reductions dominated the fetch):

    - the r axis is a UNIFORM radius grid: ``iz = (r - r0)/dr`` — no
      [B, Nr] reduction;
    - the mu axis is the :func:`sun_mu_grid_warped` asinh warp: the cell
      index is closed-form from (mu_c, s, a, b) — no [B, M] reduction;
    - the r-side two-hot weight matrix is SINGLE bf16 (its quantization
      error scales with the per-cell tau delta, ~1e-3 worst-case, not
      with tau itself); the table keeps the hi/lo bf16 split so absolute
      tau accuracy stays ~f32 through the matmul: two matmuls instead of
      three, over a [128, 128] table instead of [233, 226].

    table: [Nr, M]; r_grid: [Nr] uniform; mu_warp: (mu_c, s, a, b)
    floats; r, mu: [B]. Ground blockage is NOT in the table — callers
    apply the exact cross-product test (see :func:`sun_tau_fetch`).
    """
    Nr = r_grid.shape[0]
    M = table.shape[1]
    mu_c, s, a, b = mu_warp
    r0 = r_grid[0]
    inv_dr = (Nr - 1.0) / (r_grid[-1] - r0)

    fz = jnp.clip((r - r0) * inv_dr, 0.0, Nr - 1.0)
    ir = jnp.clip(fz.astype(jnp.int32), 0, Nr - 2)
    fr = fz - ir.astype(fz.dtype)

    iota_r = jnp.arange(Nr, dtype=jnp.int32)
    m0 = iota_r == ir[:, None]
    m1 = iota_r == (ir + 1)[:, None]
    Wr = (
        m0.astype(jnp.float32) * (1.0 - fr)[:, None]
        + m1.astype(jnp.float32) * fr[:, None]
    ).astype(jnp.bfloat16)
    tb = table.astype(jnp.bfloat16)
    tlo = (table - tb.astype(jnp.float32)).astype(jnp.bfloat16)
    rows = jnp.matmul(Wr, tb, preferred_element_type=jnp.float32) + jnp.matmul(
        Wr, tlo, preferred_element_type=jnp.float32
    )  # [B, M]

    x = (mu - mu_c) * (1.0 / s)
    t = (jnp.arcsinh(x) - a) * (1.0 / (b - a))
    ft = jnp.clip(t * (M - 1.0), 0.0, M - 1.0)
    im = jnp.clip(ft.astype(jnp.int32), 0, M - 2)
    fm = ft - im.astype(ft.dtype)
    iota_m = jnp.arange(M, dtype=jnp.int32)
    n0 = iota_m == im[:, None]
    n1 = iota_m == (im + 1)[:, None]
    Wm = (
        n0.astype(jnp.float32) * (1.0 - fm)[:, None]
        + n1.astype(jnp.float32) * fm[:, None]
    )
    return jnp.sum(rows * Wm, axis=1)


def sun_mu_grid(n_fine: int = 160, n_coarse: int = 64):
    """Local-cosine grid for the sun slant-tau table, concentrated where
    the horizon lives: for shell radii within ~120 km of an Earth-sized
    ground, the blocking boundary mu_h(r) = -sqrt(1 - (rg/r)^2) spans
    [-0.20, 0] — the table needs density there because tau varies fastest
    across the terminator; elsewhere bilinear on a coarse grid is ample.
    """
    fine = np.linspace(-0.30, 0.06, n_fine)
    lo = np.linspace(-1.0, -0.30, n_coarse // 2, endpoint=False)
    hi = np.linspace(0.06, 1.0, n_coarse // 2 + 1)[1:]
    return np.unique(np.concatenate([lo, fine, hi, [1.0, -1.0]]))


def sun_tau_fetch(table, radii, mu_grid, r, mu):
    """Bilinear sun-tau table interpolation as hi/lo-bf16 matmuls (f32).

    This fetch encodes the r-side linear interpolation as a TWO-HOT
    weight matrix ((1-f) at idx, f at idx+1) contracted against the
    [L+1, M] table in one hi/lo-bf16 matmul pair, and the mu side as a
    two-hot masked reduction — no gathers anywhere. Ground blockage is
    NOT in the table (build it with ``r_ground=0``) — the caller applies
    the exact cross-product blocked test.

    table: [L+1, M]; radii: [L+1]; mu_grid: [M]; r, mu: [B].
    """
    Lr = radii.shape[0]
    M = mu_grid.shape[0]
    ir = jnp.clip(
        jnp.sum((radii <= r[:, None]).astype(jnp.int32), axis=1) - 1, 0, Lr - 2
    )
    iota_r = jnp.arange(Lr, dtype=jnp.int32)
    m0 = iota_r == ir[:, None]
    m1 = iota_r == (ir + 1)[:, None]
    r0 = jnp.sum(jnp.where(m0, radii, 0.0), axis=1)
    dr = jnp.sum(jnp.where(m0, jnp.diff(radii, append=radii[-1:]), 0.0), axis=1)
    fr = jnp.clip((r - r0) / jnp.maximum(dr, 1e-30), 0.0, 1.0)
    Wr = (
        m0.astype(jnp.float32) * (1.0 - fr)[:, None]
        + m1.astype(jnp.float32) * fr[:, None]
    )
    hi = Wr.astype(jnp.bfloat16)
    lo = (Wr - hi.astype(jnp.float32)).astype(jnp.bfloat16)
    tb = table.astype(jnp.bfloat16)
    tlo = (table - tb.astype(jnp.float32)).astype(jnp.bfloat16)
    rows = (
        jnp.matmul(hi, tb, preferred_element_type=jnp.float32)
        + jnp.matmul(hi, tlo, preferred_element_type=jnp.float32)
        + jnp.matmul(lo, tb, preferred_element_type=jnp.float32)
    )  # [B, M]
    im = jnp.clip(
        jnp.sum((mu_grid <= mu[:, None]).astype(jnp.int32), axis=1) - 1,
        0,
        M - 2,
    )
    iota_m = jnp.arange(M, dtype=jnp.int32)
    n0 = iota_m == im[:, None]
    n1 = iota_m == (im + 1)[:, None]
    mu0 = jnp.sum(jnp.where(n0, mu_grid, 0.0), axis=1)
    dmu = jnp.sum(
        jnp.where(n0, jnp.diff(mu_grid, append=mu_grid[-1:]), 0.0), axis=1
    )
    fm = jnp.clip((mu - mu0) / jnp.maximum(dmu, 1e-30), 0.0, 1.0)
    Wm = (
        n0.astype(jnp.float32) * (1.0 - fm)[:, None]
        + n1.astype(jnp.float32) * fm[:, None]
    )
    return jnp.sum(rows * Wm, axis=1)


def lookup_sun_tau(table, radii, mu_grid, r, mu):
    """Bilinear interpolation of the per-row slant-tau table.

    table: [L+1, M] (single spectral row); r, mu: per-path scalars/batches.
    """
    i = jnp.clip(jnp.searchsorted(radii, r, side="right") - 1, 0, radii.shape[0] - 2)
    fr = jnp.clip(
        (r - radii[i]) / jnp.maximum(radii[i + 1] - radii[i], 1e-30), 0.0, 1.0
    )
    j = jnp.clip(
        jnp.searchsorted(mu_grid, mu, side="right") - 1, 0, mu_grid.shape[0] - 2
    )
    fm = jnp.clip(
        (mu - mu_grid[j]) / jnp.maximum(mu_grid[j + 1] - mu_grid[j], 1e-30), 0.0, 1.0
    )
    t00 = table[i, j]
    t01 = table[i, j + 1]
    t10 = table[i + 1, j]
    t11 = table[i + 1, j + 1]
    return (
        t00 * (1 - fr) * (1 - fm)
        + t01 * (1 - fr) * fm
        + t10 * fr * (1 - fm)
        + t11 * fr * fm
    )
