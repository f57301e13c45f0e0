"""Phase function evaluation and sampling (pure JAX, path-batched).

JAX equivalents of the reference's C++ phase plugins (SURVEY §2.1:
``rayleigh``, ``rayleigh_polarized``, ``hg``, ``isotropic``, ``tabphase``
family, ``blendphase``). All functions operate per path on a single
spectral row (the tracer vmaps over the spectral axis) and are branchless:
blend dispatch evaluates every (statically known) component and selects.

Conventions: ``cos_theta`` is the cosine of the scattering angle between the
*incident propagation direction* and the *scattered propagation direction*.
Phase functions are normalized to integrate to 1 over the sphere; values
are [1/sr]. Sampling draws the scattered direction exactly from the phase
function (importance weight 1).

Component parameter pytrees (per spectral row):
- ``rayleigh``: ``{"depol": [L]}`` per-layer depolarization factor
- ``hg``: ``{"g": []}`` asymmetry parameter
- ``isotropic``: ``{}``
- ``tab``: ``{"mu": [M], "values": [M], "cdf": [M]}`` tabulated on
  mu = cos(theta), ascending; ``cdf`` is the sampling CDF over mu.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "ortho_frame",
    "direction_from_cos",
    "direction_from_cos_u",
    "phase_eval",
    "phase_sample",
    "tab_phase_tables",
]


def ortho_frame(d):
    """Branchless orthonormal basis around unit vector d (Duff et al. 2017).

    Returns (t1, t2) with (t1, t2, d) right-handed.
    """
    z = d[..., 2]
    sign = jnp.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = d[..., 0] * d[..., 1] * a
    t1 = jnp.stack(
        [1.0 + sign * d[..., 0] ** 2 * a, sign * b, -sign * d[..., 0]], axis=-1
    )
    t2 = jnp.stack([b, sign + d[..., 1] ** 2 * a, -d[..., 1]], axis=-1)
    return t1, t2


def direction_from_cos(d_in, cos_theta, phi):
    """Scattered direction at angle (theta, phi) around incident d_in.

    Replacing ``sin(phi)`` with ``sign * sqrt(1 - cos^2)`` changed c1/c2
    by less than the run-to-run spread when measured on the previous
    accelerator, so the plain transcendental form stays. The TRANSPORT loop instead calls
    :func:`direction_from_cos_u` (round 5): libm cos+sin of the azimuth
    measured at 40% of c1 device time, and at ``phi = 2*pi*u`` the
    quadrant-reduced polynomial pair (:func:`eradiate_tpu.ops.fastmath.
    cos_sin_2pi`) is ~2.5x cheaper at f32-eps accuracy.
    """
    t1, t2 = ortho_frame(d_in)
    sin_theta = jnp.sqrt(jnp.clip(1.0 - cos_theta * cos_theta, 0.0, 1.0))
    return (
        t1 * (sin_theta * jnp.cos(phi))[..., None]
        + t2 * (sin_theta * jnp.sin(phi))[..., None]
        + d_in * cos_theta[..., None]
    )


def direction_from_cos_u(d_in, cos_theta, u_phi):
    """:func:`direction_from_cos` with the azimuth given in TURNS
    (``phi = 2*pi*u_phi``): the unit-uniform argument makes the
    cos/sin pair a quadrant floor + two degree-4 polynomials
    (:func:`~eradiate_tpu.ops.fastmath.cos_sin_2pi`)."""
    from .fastmath import cos_sin_2pi

    t1, t2 = ortho_frame(d_in)
    sin_theta = jnp.sqrt(jnp.clip(1.0 - cos_theta * cos_theta, 0.0, 1.0))
    cp, sp = cos_sin_2pi(u_phi)
    return (
        t1 * (sin_theta * cp)[..., None]
        + t2 * (sin_theta * sp)[..., None]
        + d_in * cos_theta[..., None]
    )


# ---------------------------------------------------------------------------
# Per-kind scalar phase functions p(cos_theta) [1/sr]
# ---------------------------------------------------------------------------


def _rayleigh_ab(depol):
    """Coefficients (a, b) of p ∝ a + b cos^2 with Chandrasekhar
    depolarization: gamma = depol / (2 - depol)."""
    gamma = depol / (2.0 - depol)
    return 1.0 + 3.0 * gamma, 1.0 - gamma


def rayleigh_eval(depol, cos_theta):
    a, b = _rayleigh_ab(depol)
    norm = 3.0 / (16.0 * jnp.pi * (1.0 + 2.0 * (depol / (2.0 - depol))))
    return norm * (a + b * cos_theta * cos_theta)


def rayleigh_sample_cos(depol, u):
    """Exact inverse-CDF sample of cos_theta from a + b cos^2.

    Mixture decomposition: uniform (mass 2a) + cubic |u|^(1/3) (mass 2b/3);
    both components sampled in closed form — branchless.
    """
    a, b = _rayleigh_ab(depol)
    w_uniform = (2.0 * a) / (2.0 * a + 2.0 * b / 3.0)
    u1, u2 = u[..., 0], u[..., 1]
    t = 2.0 * u2 - 1.0
    cos_uniform = t
    cos_cubic = jnp.cbrt(t)
    return jnp.where(u1 < w_uniform, cos_uniform, cos_cubic)


def hg_eval(g, cos_theta):
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return (1.0 - g * g) / (4.0 * jnp.pi * jnp.power(jnp.maximum(denom, 1e-12), 1.5))


def hg_sample_cos(g, u):
    u1 = u[..., 0]
    g_safe = jnp.where(jnp.abs(g) < 1e-4, 1e-4, g)
    sqr = (1.0 - g * g) / (1.0 - g_safe + 2.0 * g_safe * u1)
    cos_hg = (1.0 + g * g - sqr * sqr) / (2.0 * g_safe)
    cos_iso = 2.0 * u1 - 1.0
    return jnp.where(jnp.abs(g) < 1e-4, cos_iso, jnp.clip(cos_hg, -1.0, 1.0))


def iso_eval(cos_theta):
    return jnp.full(jnp.shape(cos_theta), 1.0 / (4.0 * jnp.pi))


def tab_phase_tables(mu, values):
    """Precompute the sampling CDF for a tabulated phase function.

    ``mu`` ascending [M], ``values`` [.., M] phase values [1/sr]. Returns
    (values_normalized, cdf) where cdf is over mu via trapezoid, and values
    are rescaled so 2*pi * integral(values dmu) = 1.
    """
    import numpy as np

    mu = np.asarray(mu, dtype=np.float64)
    v = np.asarray(values, dtype=np.float64)
    seg = 0.5 * (v[..., 1:] + v[..., :-1]) * np.diff(mu)
    integral = 2.0 * np.pi * np.sum(seg, axis=-1, keepdims=True)
    v = v / integral
    seg = seg / integral
    cdf = np.concatenate(
        [np.zeros(v.shape[:-1] + (1,)), np.cumsum(seg * 2.0 * np.pi, axis=-1)], axis=-1
    )
    # guard: force cdf[-1] = 1 exactly
    cdf = cdf / cdf[..., -1:]
    return v, cdf


def theta_grid_params(mu):
    """(theta0, inv_dtheta) when ``mu`` is uniform in theta, else None.

    A theta-uniform grid (the Mie datasets since round 5) lets
    :func:`tab_eval` locate its cell as ``k = (theta0 - acos(c)) *
    inv_dtheta`` — one arccos instead of a [B, M] compare-sum."""
    import numpy as np

    theta = np.arccos(np.clip(np.asarray(mu, np.float64), -1.0, 1.0))
    d = np.diff(theta)
    if d.size and np.allclose(d, d[0], rtol=1e-6, atol=1e-9) and d[0] < 0:
        return float(theta[0]), float(1.0 / (-d[0]))
    return None


def tab_eval(params, cos_theta):
    # per-bounce table fetch: masked reductions over the [M] mu grid were
    # the dominant share of the c2 transport fusions (previous accelerator). On a
    # theta-uniform grid (params["tg0"]/["itg"] present, the Mie
    # datasets) the cell index is ARITHMETIC — one arccos + a poly cos
    # replace the [B, M] compare-sum and the masked x0/dx reductions;
    # the (values, mu) pair fetch keeps the one-hot hi/lo-bf16 matmul.
    from .medium import fetch_pairs_at, interp_fetch

    if params.get("tg0") is not None:
        M = params["mu"].shape[-1]
        c = jnp.clip(cos_theta, -1.0, 1.0)
        theta = jnp.arccos(c)
        k = jnp.clip(
            ((params["tg0"] - theta) * params["itg"]).astype(jnp.int32),
            0,
            M - 2,
        )
        (v0, dv), (m0, dm) = fetch_pairs_at(
            k, (params["values"], params["mu"])
        )
        frac = jnp.clip((c - m0) / jnp.where(dm == 0.0, 1.0, dm), 0.0, 1.0)
        return v0 + frac * dv
    _, frac, ((v0, dv),) = interp_fetch(
        cos_theta, params["mu"], (params["values"],)
    )
    return v0 + frac * dv


def tab_sample_cos(params, u):
    # NOTE (round-5 negative result): replacing the CDF compare-sum with
    # an equal-probability inverse table (arithmetic u index, [Nu] fetch)
    # measured 11-13% SLOWER end-to-end on c2 at Nu = 128 and 256 — the
    # bracket reductions fuse into the surrounding transport passes,
    # while the inverse-table one-hot matmul is new standalone work. The
    # same rework on the EVAL side (theta-uniform arccos index,
    # tab_eval above) wins ~11%; sampling keeps the CDF inversion.
    from .medium import interp_fetch

    u1 = u[..., 0]
    _, frac, ((m0, dm),) = interp_fetch(u1, params["cdf"], (params["mu"],))
    return m0 + frac * dm


# ---------------------------------------------------------------------------
# Blend dispatch (static component list)
# ---------------------------------------------------------------------------


def _component_eval(kind, params, layer, cos_theta):
    from .medium import take_1d

    if kind == "rayleigh":
        return rayleigh_eval(take_1d(params["depol"], layer), cos_theta)
    if kind == "hg":
        return hg_eval(params["g"], cos_theta)
    if kind == "isotropic":
        return iso_eval(cos_theta)
    if kind in ("tab", "tab_polarized"):
        # tab_polarized carries the scalar phase in "values" plus the
        # Mueller rows (m12..m44) consumed by the polarized tracers;
        # scalar transport sees the m11 row only
        return tab_eval(params, cos_theta)
    raise ValueError(f"unknown phase kind '{kind}'")


def _component_sample_cos(kind, params, layer, u):
    from .medium import take_1d

    if kind == "rayleigh":
        return rayleigh_sample_cos(take_1d(params["depol"], layer), u)
    if kind == "hg":
        return hg_sample_cos(params["g"], u)
    if kind == "isotropic":
        return 2.0 * u[..., 0] - 1.0
    if kind in ("tab", "tab_polarized"):
        return tab_sample_cos(params, u)
    raise ValueError(f"unknown phase kind '{kind}'")


def phase_eval(phase_kinds, phase_params, phase_weights, layer, cos_theta):
    """Blend-weighted phase value at a collision.

    phase_weights: [C, L]; layer: [] int; cos_theta: [].
    """
    from .medium import take_1d

    total = 0.0
    for c, kind in enumerate(phase_kinds):
        w = take_1d(phase_weights[c], layer)
        total = total + w * _component_eval(kind, phase_params[c], layer, cos_theta)
    return total


def phase_sample_from_uniforms(
    phase_kinds, phase_params, phase_weights, layer, d_in, u_sel, u_cos, u_phi
):
    """Sample scattered directions from the blend at ``layer`` using
    pre-drawn uniforms (batch-friendly: the caller draws bulk randoms once
    per iteration instead of deriving per-path keys).

    ``layer`` [...], ``d_in`` [..., 3], ``u_sel``/``u_phi`` [...],
    ``u_cos`` [..., 2]. Component selection by weight, then exact
    per-component cos sampling; all components are evaluated branchlessly
    and selected (C is small and static).
    """
    from .medium import take_1d

    C = len(phase_kinds)
    ws = [take_1d(phase_weights[c], layer) for c in range(C)]
    total = sum(ws)
    cos_theta = 0.0
    cdf = 0.0
    for c, kind in enumerate(phase_kinds):
        cdf = cdf + ws[c] / jnp.maximum(total, 1e-30)
        cos_c = _component_sample_cos(kind, phase_params[c], layer, u_cos)
        selected = (u_sel < cdf) if c == 0 else (u_sel < cdf) & ~prev_cdf_hit
        cos_theta = jnp.where(selected, cos_c, cos_theta)
        prev_cdf_hit = u_sel < cdf
    return direction_from_cos_u(d_in, cos_theta, u_phi)


def phase_sample(phase_kinds, phase_params, phase_weights, layer, d_in, key):
    """Key-based wrapper over :func:`phase_sample_from_uniforms`."""
    k_sel, k_cos, k_phi = jax.random.split(key, 3)
    return phase_sample_from_uniforms(
        phase_kinds,
        phase_params,
        phase_weights,
        layer,
        d_in,
        jax.random.uniform(k_sel),
        jax.random.uniform(k_cos, (2,)),
        jax.random.uniform(k_phi),
    )


# ---------------------------------------------------------------------------
# Prefetched-parameter variants: the tracer fetches all per-layer data
# (blend weights + layer-indexed component params) in ONE fused dense pass
# (``medium.collision_fetch``), then evaluates/samples with the fetched
# values — avoiding one [B, L] HBM pass per table per bounce.
# ---------------------------------------------------------------------------


def layer_param_slots(phase_kinds, phase_params):
    """Per-layer parameter tables the components index by layer.

    Returns (tables, slots): ``tables`` is a list of [L] arrays to hand to
    ``collision_fetch``; ``slots`` the matching (component, name) keys used
    to rebuild per-path param dicts.
    """
    tables, slots = [], []
    for c, kind in enumerate(phase_kinds):
        if kind == "rayleigh":
            tables.append(phase_params[c]["depol"])
            slots.append((c, "depol"))
    return tables, slots


def rebuild_fetched(phase_kinds, slots, fetched):
    """Arrange fetched per-path values into a per-component tuple of dicts
    (a pytree that vmaps alongside the path batch)."""
    at = [dict() for _ in phase_kinds]
    for (c, name), val in zip(slots, fetched):
        at[c][name] = val
    return tuple(at)


def _component_eval_at(kind, params, at, cos_theta):
    if kind == "rayleigh":
        return rayleigh_eval(at["depol"], cos_theta)
    if kind == "hg":
        return hg_eval(params["g"], cos_theta)
    if kind == "isotropic":
        return iso_eval(cos_theta)
    if kind in ("tab", "tab_polarized"):
        return tab_eval(params, cos_theta)
    raise ValueError(f"unknown phase kind '{kind}'")


def _component_sample_cos_at(kind, params, at, u):
    if kind == "rayleigh":
        return rayleigh_sample_cos(at["depol"], u)
    if kind == "hg":
        return hg_sample_cos(params["g"], u)
    if kind == "isotropic":
        return 2.0 * u[..., 0] - 1.0
    if kind in ("tab", "tab_polarized"):
        return tab_sample_cos(params, u)
    raise ValueError(f"unknown phase kind '{kind}'")


def phase_eval_at(phase_kinds, phase_params, weights_at, params_at, cos_theta):
    """Blend-weighted phase value with prefetched per-path data.

    ``weights_at``: [C] blend weights at the collision layer; ``params_at``:
    per-component dicts of prefetched layer params (see
    :func:`rebuild_fetched`); ``cos_theta``: [] scattering cosine.
    """
    total = 0.0
    for c, kind in enumerate(phase_kinds):
        total = total + weights_at[c] * _component_eval_at(
            kind, phase_params[c], params_at[c], cos_theta
        )
    return total


def phase_sample_at(
    phase_kinds, phase_params, weights_at, params_at, d_in, u_sel, u_cos, u_phi
):
    """Sample a scattered direction from the blend with prefetched data
    (prefetched counterpart of :func:`phase_sample_from_uniforms`)."""
    total = 0.0
    for c in range(len(phase_kinds)):
        total = total + weights_at[c]
    cos_theta = 0.0
    cdf = 0.0
    for c, kind in enumerate(phase_kinds):
        cdf = cdf + weights_at[c] / jnp.maximum(total, 1e-30)
        cos_c = _component_sample_cos_at(kind, phase_params[c], params_at[c], u_cos)
        selected = (u_sel < cdf) if c == 0 else (u_sel < cdf) & ~prev_cdf_hit
        cos_theta = jnp.where(selected, cos_c, cos_theta)
        prev_cdf_hit = u_sel < cdf
    return direction_from_cos_u(d_in, cos_theta, u_phi)
