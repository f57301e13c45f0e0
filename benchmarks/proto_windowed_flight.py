"""Prototype: windowed two-level shell flight vs the dense shell flight.

The shell flight (``ops/spherical.shell_flight``) dominated c4 device
time on the previous accelerator. This prototype replaces the O(B*W)
per-event prefix with:

- a precomputed coarse table Gc[b_i, k] = tau from the ground-or-tangent
  anchor to coarse radius R_k at impact parameter b_i (K ~ 16 coarse
  super-shells of G = W/K fine shells each), fetched per lane by 1D
  linear interpolation in b (one row gather per lane);
- exact O(B*G) evaluation/inversion inside the single coarse window that
  contains the event.

Interpolation error enters ONLY through the b-interpolation of Gc; the
fine structure inside the landing window is exact.

Run: python benchmarks/proto_windowed_flight.py (from the repo root)
"""

import time

import numpy as np

import jax
import jax.numpy as jnp

from eradiate_tpu.ops.spherical import shell_flight

B = 65536
SEED = 0


# --------------------------------------------------------------------------
# medium: c4-like merged profile
# --------------------------------------------------------------------------

def c4_medium():
    import eradiate_tpu as ert
    from eradiate_tpu.experiments import AtmosphereExperiment
    from eradiate_tpu.scenes.geometry import EARTH_RADIUS_KM

    ert.set_mode("mono_single")
    exp = AtmosphereExperiment(
        geometry={"type": "spherical_shell"},
        illumination={"type": "directional", "zenith": 75.0, "azimuth": 0.0},
        measures={
            "type": "mdistant", "construct": "hplane",
            "zeniths": np.arange(-85.0, 65.0, 10.0), "azimuth": 0.0,
            "target": [0.0, 0.0, EARTH_RADIUS_KM], "id": "m",
        },
        surface={"type": "hapke"},
        atmosphere={"type": "molecular"},
    )
    exp.init()
    measure = exp.measures[0]
    ctx = exp.spectral_context(measure)
    scene, sensor, config = exp.compile_scene(measure, ctx)
    return scene.medium


# --------------------------------------------------------------------------
# windowed flight
# --------------------------------------------------------------------------

def build_tables(radii, sigma, K=16, n_band=1408, n_low=128, band_km=40.0):
    """Precompute (static numpy b-grid, coarse-G table, grouped fine data)."""
    radii = np.asarray(radii, np.float64)
    sigma = np.asarray(sigma, np.float64)
    W = sigma.shape[0]
    G = -(-W // K)
    pad = K * G - W
    radii_p = np.concatenate([radii, np.full(pad, radii[-1])])
    sigma_p = np.concatenate([sigma, np.zeros(pad)])

    rg, rt = radii[0], radii[-1]
    b_lo = np.linspace(0.0, rg - band_km, n_low, endpoint=False)
    b_hi = np.linspace(rg - band_km, rt, n_band)
    b_grid = np.concatenate([b_lo, b_hi])

    X = np.sqrt(np.maximum(radii_p[None, :] ** 2 - b_grid[:, None] ** 2, 0.0))
    c = sigma_p[None, :] * np.diff(X, axis=1)
    Gfull = np.concatenate(
        [np.zeros((b_grid.shape[0], 1)), np.cumsum(c, axis=1)], axis=1
    )
    Gc_tab = Gfull[:, ::G]  # [Nb, K+1]

    R2f = (radii_p ** 2)
    R2g = np.stack([R2f[k * G : k * G + G + 1] for k in range(K)])  # [K, G+1]
    sigf = sigma_p.reshape(K, G)

    params = dict(
        K=K, G=G, W=W,
        b0_lo=0.0, db_lo=(rg - band_km) / n_low, n_lo=n_low,
        b0_hi=rg - band_km, db_hi=(rt - (rg - band_km)) / (n_band - 1),
        Nb=b_grid.shape[0],
    )
    return (
        jnp.asarray(Gc_tab, jnp.float32),
        jnp.asarray(R2g, jnp.float32),
        jnp.asarray(sigf, jnp.float32),
        jnp.asarray((radii_p[::G]) ** 2, jnp.float32),  # Rc2 [K+1]
        params,
    )


def windowed_flight(x0, b2, t_max, tau_s, Gc_tab, R2g, sigf, Rc2, params):
    K, G, W = params["K"], params["G"], params["W"]
    b = jnp.sqrt(b2)
    desc = x0 < 0.0
    ax0 = jnp.abs(x0)
    x_max = x0 + t_max

    # --- coarse-G fetch: piecewise-uniform grid, arithmetic index -------
    in_hi = b >= params["b0_hi"]
    idx = jnp.where(
        in_hi,
        params["n_lo"] + (b - params["b0_hi"]) / params["db_hi"],
        (b - params["b0_lo"]) / params["db_lo"],
    )
    ir = jnp.clip(idx.astype(jnp.int32), 0, params["Nb"] - 2)
    f = jnp.clip(idx - ir.astype(idx.dtype), 0.0, 1.0)
    g0 = jnp.take(Gc_tab, ir, axis=0)
    g1 = jnp.take(Gc_tab, ir + 1, axis=0)
    Gc = g0 * (1.0 - f[:, None]) + g1 * f[:, None]  # [B, K+1]

    Xc = jnp.sqrt(jnp.maximum(Rc2[None, :] - b2[:, None], 0.0))  # [B, K+1]

    # --- forward eval at |x0| ------------------------------------------
    kc = jnp.clip(
        jnp.sum((Xc <= ax0[:, None]).astype(jnp.int32), axis=1) - 1, 0, K - 1
    )
    R2w = jnp.take(R2g, kc, axis=0)  # [B, G+1]
    sgw = jnp.take(sigf, kc, axis=0)  # [B, G]
    Xw = jnp.sqrt(jnp.maximum(R2w - b2[:, None], 0.0))
    hi_clip = jnp.minimum(Xw[:, 1:], ax0[:, None])
    lo_clip = jnp.minimum(Xw[:, :-1], ax0[:, None])
    tau_in = jnp.sum(sgw * jnp.maximum(hi_clip - lo_clip, 0.0), axis=1)
    A = jnp.take_along_axis(Gc, kc[:, None], axis=1)[:, 0] + tau_in

    # --- tau to the exit (exit-clipped contract) ------------------------
    GmK = Gc[:, -1]
    tau_max = jnp.where(
        desc, jnp.where(x_max < 0.0, A, A + GmK), GmK - A
    )
    collide = tau_s < jnp.maximum(tau_max, 0.0)

    # --- inversion ------------------------------------------------------
    on_desc = desc & (tau_s < A)
    v = jnp.where(on_desc, A - tau_s, jnp.where(desc, tau_s - A, A + tau_s))
    kc2 = jnp.clip(
        jnp.sum((Gc <= v[:, None]).astype(jnp.int32), axis=1) - 1, 0, K - 1
    )
    R2w2 = jnp.take(R2g, kc2, axis=0)
    sgw2 = jnp.take(sigf, kc2, axis=0)
    Xw2 = jnp.sqrt(jnp.maximum(R2w2 - b2[:, None], 0.0))
    cg = sgw2 * jnp.diff(Xw2, axis=1)  # [B, G]
    base = jnp.take_along_axis(Gc, kc2[:, None], axis=1)
    Gg = base + jnp.concatenate(
        [jnp.zeros_like(base), jnp.cumsum(cg, axis=1)], axis=1
    )  # [B, G+1]
    jf = jnp.clip(
        jnp.sum((Gg <= v[:, None]).astype(jnp.int32), axis=1) - 1, 0, G - 1
    )
    Gk = jnp.take_along_axis(Gg, jf[:, None], axis=1)[:, 0]
    Xk = jnp.take_along_axis(Xw2, jf[:, None], axis=1)[:, 0]
    sk = jnp.take_along_axis(sgw2, jf[:, None], axis=1)[:, 0]
    y = Xk + (v - Gk) / jnp.maximum(sk, 1e-30)
    x_col = jnp.where(on_desc, -y, y)
    t_col = jnp.clip(x_col - x0, 0.0, t_max)
    layer = jnp.clip(kc2 * G + jf, 0, W - 1)
    return collide, t_col, layer


# --------------------------------------------------------------------------
# event-state generator: positions/directions as the tracer sees them
# --------------------------------------------------------------------------

def make_states(radii, key, B):
    rg, rt = float(radii[0]), float(radii[-1])
    k1, k2, k3, k4 = jax.random.split(key, 4)
    # mix: TOA entries at view zeniths up to 85 deg + interior scatters
    r = jnp.where(
        jax.random.uniform(k1, (B,)) < 0.3,
        rt,
        rg + (rt - rg) * jax.random.uniform(k2, (B,)) ** 2.0,
    )
    mu = jax.random.uniform(k3, (B,), minval=-1.0, maxval=1.0)
    # TOA entries must point inward
    mu = jnp.where(r >= rt, -jnp.abs(mu), mu)
    p = jnp.stack([jnp.zeros(B), jnp.zeros(B), r], axis=1)
    s = jnp.sqrt(jnp.maximum(1.0 - mu * mu, 0.0))
    d = jnp.stack([s, jnp.zeros(B), mu], axis=1)
    tau_s = -jnp.log1p(-jax.random.uniform(k4, (B,)))
    return p, d, tau_s


def main():
    med = c4_medium()

    radii = np.asarray(med.radii)
    sigma = np.asarray(med.sigma_t[0])
    print(f"W = {sigma.shape[0]} shells, rg={radii[0]:.1f} rt={radii[-1]:.1f}")

    Gc_tab, R2g, sigf, Rc2, params = build_tables(radii, sigma)
    radii_j = jnp.asarray(radii, jnp.float32)
    sigma_j = jnp.asarray(sigma, jnp.float32)

    p, d, tau_s = make_states(radii, jax.random.key(SEED), B)
    x0 = jnp.sum(p * d, axis=-1)
    b2 = jnp.sum(jnp.cross(p, d) ** 2, axis=-1)
    # exit-clipped t_max as the tracer computes it
    from eradiate_tpu.ops.spherical import ray_sphere_intersect

    tgn, tgf, hit_g = ray_sphere_intersect(p, d, radii_j[0])
    t_ground = jnp.where(hit_g & (tgn > 1e-4), tgn, jnp.inf)
    _, ttf, _ = ray_sphere_intersect(p, d, radii_j[-1])
    t_max = jnp.minimum(t_ground, jnp.maximum(ttf, 1e-4))

    # --- accuracy vs exact XLA (f32) -----------------------------------
    col_e, t_e, lay_e = shell_flight(p, d, t_max, radii_j, sigma_j, tau_s)
    col_w, t_w, lay_w = windowed_flight(
        x0, b2, t_max, tau_s, Gc_tab, R2g, sigf, Rc2, params
    )
    col_e, t_e, lay_e, col_w, t_w, lay_w = map(
        np.asarray, (col_e, t_e, lay_e, col_w, t_w, lay_w)
    )
    agree = col_e == col_w
    print(f"collide agreement: {agree.mean()*100:.4f}%")
    both = col_e & col_w
    dt = np.abs(t_w[both] - t_e[both])
    print(f"t_col: max |dt| {dt.max():.4g} km  p99 {np.percentile(dt, 99):.4g}")
    print(f"layer agreement: {(lay_e[both]==lay_w[both]).mean()*100:.4f}%")

    # --- speed ----------------------------------------------------------
    f_win = jax.jit(
        lambda: windowed_flight(
            x0, b2, t_max, tau_s, Gc_tab, R2g, sigf, Rc2, params
        )
    )
    f_dense = jax.jit(
        lambda: shell_flight(p, d, t_max, radii_j, sigma_j, tau_s)
    )
    for name, fn in [("windowed", f_win), ("dense", f_dense)]:
        o = fn(); jax.block_until_ready(o)
        t0 = time.perf_counter()
        for _ in range(100):
            o = fn()
        jax.block_until_ready(o)
        print(f"{name:9s} {(time.perf_counter()-t0)/100*1e3:.3f} ms")


if __name__ == "__main__":
    main()
