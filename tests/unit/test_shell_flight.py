"""Spherical-shell free flight and slant depth vs a float64 numpy reference.

``ops/spherical.shell_flight`` inverts the optical depth along a ray in
the axial coordinate of its closest approach (triangular-matmul prefix,
compare-sum brackets); ``slant_tau_exact`` sums per-shell chord lengths.
The reference here is independent of both: it intersects the ray with
every shell sphere in float64, sorts the crossings, and integrates the
piecewise-constant extinction segment by segment.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from eradiate_tpu.ops.spherical import (
    TAU_BLOCKED,
    ray_sphere_intersect,
    shell_event,
    shell_flight,
    slant_tau_exact,
)

R_EARTH = 6378.1


def make_shells(L=200, B=700, seed=0):
    rng = np.random.default_rng(seed)
    radii = np.linspace(R_EARTH, R_EARTH + 120.0, L + 1).astype(np.float32)
    sigma = (np.exp(-np.linspace(0, 120, L) / 8.5) * 0.01).astype(np.float32)
    r0 = rng.uniform(R_EARTH + 1e-3, R_EARTH + 119.9, B)
    theta = rng.uniform(0, np.pi / 6, B)
    phi = rng.uniform(0, 2 * np.pi, B)
    p = np.stack(
        [
            r0 * np.sin(theta) * np.cos(phi),
            r0 * np.sin(theta) * np.sin(phi),
            r0 * np.cos(theta),
        ],
        axis=1,
    ).astype(np.float32)
    return radii, sigma, p, rng


def _unit(v):
    v = np.asarray(v, np.float32)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _exit_distance(p, d, radii):
    """Tracer contract: t_max is the ground-or-top exit distance."""
    tgn, _, hit_g = ray_sphere_intersect(p, d, radii[0])
    t_ground = jnp.where(hit_g & (tgn > 1e-4), tgn, jnp.inf)
    _, ttf, _ = ray_sphere_intersect(p, d, radii[-1])
    return np.asarray(jnp.minimum(t_ground, jnp.maximum(ttf, 1e-4)))


def _segments(p, d, t_end, radii, sigma):
    """Per ray: segment end points [0 = t_0 < ... < t_m = t_end], the
    shell index of each segment (-1 outside the atmosphere) and its
    extinction, all float64."""
    p, d = np.asarray(p, np.float64), np.asarray(d, np.float64)
    R = np.asarray(radii, np.float64)
    sig = np.asarray(sigma, np.float64)
    x0 = np.sum(p * d, axis=1)
    c = np.sum(p * p, axis=1)
    out = []
    for i in range(p.shape[0]):
        disc = x0[i] ** 2 - c[i] + R * R
        sq = np.sqrt(disc[disc >= 0])
        roots = np.concatenate([-x0[i] - sq, -x0[i] + sq])
        ts = np.unique(np.concatenate(
            [[0.0, t_end[i]], roots[(roots > 0) & (roots < t_end[i])]]
        ))
        mid = 0.5 * (ts[:-1] + ts[1:])
        r_mid = np.linalg.norm(p[i] + mid[:, None] * d[i], axis=1)
        k = np.searchsorted(R, r_mid, side="right") - 1
        inside = (k >= 0) & (k < sig.size)
        s = np.where(inside, sig[np.clip(k, 0, sig.size - 1)], 0.0)
        out.append((ts, np.where(inside, k, -1), s))
    return out


def _flight_ref(p, d, t_max, tau_s, radii, sigma):
    collide, t_col, layer = [], [], []
    for ts, k, s in _segments(p, d, t_max, radii, sigma):
        cum = np.concatenate([[0.0], np.cumsum(s * np.diff(ts))])
        tau = float(tau_s[len(collide)])
        hit = tau < cum[-1]
        j = min(np.searchsorted(cum, tau, side="right") - 1, len(s) - 1)
        collide.append(hit)
        t_col.append(ts[j] + (tau - cum[j]) / max(s[j], 1e-30) if hit else 0)
        layer.append(k[j] if hit else -1)
    return np.array(collide), np.array(t_col), np.array(layer)


def _check_flight(p, d, t_max, tau_s, radii, sigma):
    got = shell_flight(
        jnp.asarray(p), jnp.asarray(d), jnp.asarray(t_max),
        jnp.asarray(radii), jnp.asarray(sigma), jnp.asarray(tau_s),
    )
    col, t, lay = (np.asarray(a) for a in got)
    col_r, t_r, lay_r = _flight_ref(p, d, t_max, tau_s, radii, sigma)
    # tau_s within f32 rounding of the total depth may flip; stay rare
    assert (col != col_r).mean() < 0.005
    both = col & col_r
    assert both.sum() > 50
    # f32 axial coordinates at planet scale: ~5e-4 km ulp, long chords
    np.testing.assert_allclose(t[both], t_r[both], rtol=1e-4, atol=1e-2)
    # a collision within rounding of a shell boundary may land next door
    assert (lay[both] == lay_r[both]).mean() > 0.99
    assert np.all(np.abs(lay[both] - lay_r[both]) <= 1)
    assert np.all(t[col] <= t_max[col])


def test_flight_to_boundary_exits():
    """Random directions, t_max = the boundary-exit distance."""
    radii, sigma, p, rng = make_shells()
    d = _unit(rng.normal(size=p.shape))
    t_max = _exit_distance(p, d, radii)
    tau_s = rng.exponential(0.3, p.shape[0]).astype(np.float32)
    _check_flight(p, d, t_max, tau_s, radii, sigma)


def test_flight_with_shortened_cap():
    """t_max a random fraction of the exit distance (surface or leaf hits
    cut the flight short in the tracers)."""
    radii, sigma, p, rng = make_shells(seed=4)
    d = _unit(rng.normal(size=p.shape))
    frac = rng.uniform(0.05, 1.0, p.shape[0]).astype(np.float32)
    t_max = (_exit_distance(p, d, radii) * frac).astype(np.float32)
    tau_s = rng.exponential(0.1, p.shape[0]).astype(np.float32)
    _check_flight(p, d, t_max, tau_s, radii, sigma)


def test_flight_ground_anchor():
    """Steep descending rays whose tangent point lies below the ground
    (b < r_ground): the inversion anchors at the ground level."""
    radii, sigma, p, rng = make_shells(seed=1)
    B = p.shape[0]
    d = _unit(np.stack(
        [rng.uniform(-0.05, 0.05, B), rng.uniform(-0.05, 0.05, B),
         -np.ones(B)], axis=1,
    ))
    t_max = _exit_distance(p, d, radii)
    tau_s = rng.exponential(0.2, B).astype(np.float32)
    _check_flight(p, d, t_max, tau_s, radii, sigma)


def _slant_ref(p, w, radii, sigma):
    """float64 slant depth to the top; TAU_BLOCKED where the ground
    sphere blocks the ray."""
    p = np.asarray(p, np.float64)
    wv = np.broadcast_to(np.asarray(w, np.float64), p.shape)
    x0 = np.sum(p * wv, axis=1)
    c = np.sum(p * p, axis=1)
    t_top = -x0 + np.sqrt(x0 * x0 - c + float(radii[-1]) ** 2)
    tau = np.array([
        np.sum(s * np.diff(ts))
        for ts, _, s in _segments(p, wv, t_top, radii, sigma)
    ])
    b2 = np.sum(np.cross(p, wv) ** 2, axis=1)
    blocked = (x0 < 0) & (b2 < float(radii[0]) ** 2)
    return np.where(blocked, TAU_BLOCKED, tau)


@pytest.mark.parametrize("zenith", [0.0, 60.0, 85.0, 95.0])
def test_slant_tau_across_zenith(zenith):
    radii, sigma, p, _ = make_shells(B=300)
    z = np.deg2rad(zenith)
    w = np.array([np.sin(z), 0.0, np.cos(z)], np.float32)
    got = np.asarray(slant_tau_exact(
        jnp.asarray(p), jnp.asarray(w), jnp.asarray(radii),
        jnp.asarray(sigma),
    ))
    ref = _slant_ref(p, w, radii, sigma)
    blk_r = ref >= TAU_BLOCKED / 2
    np.testing.assert_array_equal(got >= TAU_BLOCKED / 2, blk_r)
    ok = ~blk_r
    assert ok.sum() > 100
    # near-tangent chords carry an f32 noise floor of a few 1e-2 absolute
    np.testing.assert_allclose(got[ok], ref[ok], atol=5e-2, rtol=2e-2)


def test_shell_event_equals_two_step():
    """shell_event = shell_flight, then the exact slant depth to the sun
    at the event point (collision, or the flight cap)."""
    radii, sigma, p, rng = make_shells(seed=3)
    d = _unit(rng.normal(size=p.shape))
    w_sun = _unit([0.3, 0.1, 0.9486833])
    t_max = _exit_distance(p, d, radii)
    tau_s = rng.exponential(0.3, p.shape[0]).astype(np.float32)
    args = [jnp.asarray(a) for a in (p, d, t_max, radii, sigma, tau_s)]
    col, t_col, layer, tau_sun = shell_event(*args, jnp.asarray(w_sun))
    col_r, t_r, lay_r = shell_flight(*args)
    t_step = jnp.where(col_r, t_r, args[2])
    p_new = args[0] + args[1] * t_step[:, None]
    tau_r = slant_tau_exact(p_new, jnp.asarray(w_sun), args[3], args[4])
    for a, b in ((col, col_r), (t_col, t_r), (layer, lay_r),
                 (tau_sun, tau_r)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
