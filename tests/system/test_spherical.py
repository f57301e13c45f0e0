"""System tests: spherical-shell geometry.

Mirror of the reference's ``tests/03_regression/spherical`` intent with
self-contained oracles:
- slant-tau table against brute-force numerical integration;
- no atmosphere: BRF == reflectance (sphere surface, nadir target);
- thin atmosphere: spherical results converge to plane-parallel at low SZA;
- high SZA (75 deg+) with Hapke surface runs and produces finite output
  (BASELINE config 4 shape).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import eradiate_tpu
from eradiate_tpu.experiments import AtmosphereExperiment
from eradiate_tpu.ops.spherical import (
    lookup_sun_tau,
    ray_sphere_intersect,
    sun_tau_table,
)


class TestSlantTau:
    def test_vertical_matches_sum(self):
        radii = jnp.asarray(6378.0 + np.linspace(0, 100, 51))
        sigma = jnp.asarray(np.full((1, 50), 0.01))
        mu_grid = jnp.asarray(np.linspace(-1, 1, 65))
        table = sun_tau_table(sigma, radii, mu_grid)
        # straight up from the ground: tau = 0.01 * 100
        tau_up = float(lookup_sun_tau(table[0], radii, mu_grid, radii[0], 1.0))
        np.testing.assert_allclose(tau_up, 1.0, rtol=1e-5)
        # from the top: zero
        tau_top = float(lookup_sun_tau(table[0], radii, mu_grid, radii[-1], 1.0))
        np.testing.assert_allclose(tau_top, 0.0, atol=1e-6)

    def test_slant_against_numerical(self):
        rng = np.random.default_rng(0)
        R = 6378.0
        z = np.linspace(0, 100, 101)
        radii_np = R + z
        sigma_np = 0.012 * np.exp(-z[:-1] / 8.0)[None, :]
        mu_grid = np.sign(np.linspace(-1, 1, 193)) * np.linspace(-1, 1, 193) ** 2
        table = sun_tau_table(
            jnp.asarray(sigma_np), jnp.asarray(radii_np), jnp.asarray(mu_grid)
        )

        def numerical_tau(r0, mu):
            # march the ray numerically
            p = np.array([0.0, np.sqrt(1 - mu**2) * 0, r0])
            d = np.array([np.sqrt(max(1 - mu**2, 0)), 0.0, mu])
            # rotate so local up is +z at start: p = (0,0,r0), local mu wrt z
            ds = 0.05
            tau = 0.0
            for _ in range(200000):
                p = p + d * ds
                r = np.linalg.norm(p)
                if r >= radii_np[-1]:
                    return tau
                if r <= radii_np[0]:
                    return 1e10
                k = np.searchsorted(radii_np, r) - 1
                tau += sigma_np[0, min(max(k, 0), 99)] * ds
            return tau

        for r0, mu in [(R + 0.0, 0.8), (R + 20.0, 0.3), (R + 5.0, -0.05), (R + 50.0, 0.05)]:
            t_num = numerical_tau(r0, mu)
            t_tab = float(
                lookup_sun_tau(table[0], jnp.asarray(radii_np), jnp.asarray(mu_grid), r0, mu)
            )
            if t_num > 1e9:
                assert t_tab > 1e9 or t_tab > 100.0
            else:
                np.testing.assert_allclose(t_tab, t_num, rtol=0.02, atol=0.002)

    def test_ground_blockage(self):
        radii = jnp.asarray(6378.0 + np.linspace(0, 100, 51))
        sigma = jnp.asarray(np.full((1, 50), 0.01))
        mu_grid = jnp.asarray(np.linspace(-1, 1, 129))
        table = sun_tau_table(sigma, radii, mu_grid)
        # steeply downward from low altitude: blocked by the planet
        tau = float(lookup_sun_tau(table[0], radii, mu_grid, radii[0] + 1.0, -0.9))
        assert tau > 1e6


class TestRaySphere:
    def test_basic(self):
        p = jnp.asarray([[0.0, 0.0, 10.0]])
        d = jnp.asarray([[0.0, 0.0, -1.0]])
        tn, tf, hit = ray_sphere_intersect(p, d, 5.0)
        assert bool(hit[0])
        np.testing.assert_allclose(float(tn[0]), 5.0)
        np.testing.assert_allclose(float(tf[0]), 15.0)


class TestSphericalExperiment:
    def test_no_atmosphere_lambertian(self, mode_mono):
        exp = AtmosphereExperiment(
            geometry={"type": "spherical_shell"},
            illumination={"type": "directional", "zenith": 30.0},
            measures={
                "type": "mdistant",
                "construct": "hplane",
                "zeniths": [-45.0, 0.0, 45.0],
                "azimuth": 0.0,
                "spp": 8,
                "id": "m",
            },
            surface={"type": "lambertian", "reflectance": 0.4},
            atmosphere=None,
        )
        result = eradiate_tpu.run(exp)
        np.testing.assert_allclose(result["brf"].values, 0.4, atol=1e-4)

    def test_converges_to_plane_parallel(self, mode_mono):
        """Rayleigh atmosphere, moderate SZA: spherical ~= plane-parallel."""
        kwargs = dict(
            illumination={"type": "directional", "zenith": 20.0},
            measures={
                "type": "mdistant",
                "construct": "hplane",
                "zeniths": [0.0, 30.0],
                "azimuth": 0.0,
                "spp": 4096,
                "id": "m",
            },
            surface={"type": "lambertian", "reflectance": 0.3},
            atmosphere={"type": "molecular"},
        )
        r_pp = eradiate_tpu.run(AtmosphereExperiment(**kwargs))
        r_sp = eradiate_tpu.run(
            AtmosphereExperiment(geometry={"type": "spherical_shell"}, **kwargs)
        )
        bp = r_pp["brf"].values[0]
        bs = r_sp["brf"].values[0]
        sig = np.pi * np.sqrt(
            r_pp["var"].values[0] + r_sp["var"].values[0]
        ) / float(r_pp["irradiance"].values[0])
        assert np.all(np.abs(bp - bs) < 5 * sig + 0.01 * bp), (bp, bs, sig)

    def test_sun_tau_table_matches_exact(self, mode_mono):
        """The default NEE sun-tau table (round 5, SphericalShellGeometry
        .sun_tau_table) must agree with the exact per-event slant
        recomputation to the documented bound. Same seed => identical
        sample trajectories (the table only enters NEE transmittance),
        so the diff is PURE interpolation error — gate it
        deterministically, far below MC noise scales. Measured on
        c4-like geometry: max 7.6e-4 measured; allow 2e-3 here."""

        def render(table):
            from eradiate_tpu.core.rng import SeedState

            exp = AtmosphereExperiment(
                geometry={"type": "spherical_shell",
                          "sun_tau_table": table},
                illumination={"type": "directional", "zenith": 75.0},
                measures={
                    "type": "mdistant",
                    "construct": "hplane",
                    "zeniths": [-60.0, -20.0, 20.0, 60.0],
                    "azimuth": 0.0,
                    "spp": 4096,
                    "id": "m",
                },
                surface={"type": "hapke"},
                atmosphere={"type": "molecular"},
            )
            exp.init()
            exp.process(seed_state=SeedState(3), mesh=None)
            m = exp.measures[0]
            scene, _, _ = exp.compile_scene(
                m, exp.spectral_context(m)
            )
            has_table = scene.medium.sun_tau is not None
            return (
                np.asarray(m.results["raw"]["radiance"]), has_table
            )

        with_table, on = render(True)
        exact, off = render(False)
        assert on and not off
        rel = np.abs(with_table - exact) / np.maximum(np.abs(exact), 1e-30)
        assert rel.max() < 2e-3, rel.max()
        # and the table path must differ at all (guard against the flag
        # silently not taking effect)
        assert rel.max() > 0.0

    def test_sun_tau_table_auto_guardrail(self, mode_mono):
        """The "auto" default takes the table at moderate sun zenith and
        the exact slant at high zenith (the terminator-cusp negative
        result, performance.md item 6); forcing True at SZA 85 must
        still stay within a documented envelope (the cusp band is ~5e-3
        |dT| worst case; end-to-end radiance error allowed to 1e-2)."""

        def compile_medium(zenith, flag):
            exp = AtmosphereExperiment(
                geometry={"type": "spherical_shell",
                          "sun_tau_table": flag},
                illumination={"type": "directional", "zenith": zenith},
                measures={"type": "mdistant", "construct": "hplane",
                          "zeniths": [0.0], "azimuth": 0.0, "spp": 16,
                          "id": "m"},
                surface={"type": "hapke"},
                atmosphere={"type": "molecular"},
            )
            exp.init()
            m = exp.measures[0]
            scene, _, _ = exp.compile_scene(m, exp.spectral_context(m))
            return exp, scene

        _, s_lo = compile_medium(60.0, "auto")
        assert s_lo.medium.sun_tau is not None
        _, s_hi = compile_medium(85.0, "auto")
        assert s_hi.medium.sun_tau is None

        # forced table at SZA 85: same-seed diff vs exact is pure
        # interpolation error; gate the high-zenith envelope
        def render(flag):
            from eradiate_tpu.core.rng import SeedState

            exp, _ = compile_medium(85.0, flag)
            exp.process(spp=4096, seed_state=SeedState(9), mesh=None)
            return np.asarray(exp.measures[0].results["raw"]["radiance"])

        forced = render(True)
        exact = render(False)
        rel = np.abs(forced - exact) / np.maximum(np.abs(exact), 1e-30)
        assert rel.max() < 1e-2, rel.max()

    def test_high_sza_hapke(self, mode_mono):
        """BASELINE config 4: spherical shell, SZA 80, Hapke surface."""
        exp = AtmosphereExperiment(
            geometry={"type": "spherical_shell"},
            illumination={"type": "directional", "zenith": 80.0},
            measures={
                "type": "mdistant",
                "construct": "hplane",
                "zeniths": [-60.0, 0.0, 60.0],
                "azimuth": 0.0,
                "spp": 512,
                "id": "m",
            },
            surface={"type": "hapke"},
            atmosphere={"type": "molecular"},
        )
        result = eradiate_tpu.run(exp)
        vals = result["brf"].values
        assert np.all(np.isfinite(vals))
        assert np.all(vals > 0.0)
        # at SZA 80 the plane-parallel limb would differ; just check the
        # magnitude is physical
        assert np.all(vals < 2.0)


class TestSlantTauExact:
    """Closed-form per-event slant tau (the tracer's production path;
    the table is kept for cross-validation)."""

    def _scene(self):
        R = 6378.0
        z = np.linspace(0, 100, 101)
        radii = jnp.asarray(R + z)
        sigma = jnp.asarray(0.012 * np.exp(-z[:-1] / 8.0))
        return R, radii, sigma

    def test_matches_f64_truth(self):
        """Compare against an f64 NumPy implementation of the same shell
        geometry (tighter than the precomputed table, which carries its own
        f32 rounding — measured 7e-4 relative at near-tangent nodes vs
        1.5e-4 for the closed form)."""
        from eradiate_tpu.ops.spherical import slant_tau_exact

        R, radii, sigma = self._scene()
        radii_np = np.asarray(radii, np.float64)
        sigma_np = np.asarray(sigma, np.float64)

        def truth(r0, m0):
            b2 = r0 * r0 * (1 - m0 * m0)
            b = np.sqrt(b2)
            lo, hi = radii_np[:-1], radii_np[1:]

            def seg(ra, rb):
                fa = np.sqrt(np.maximum(ra * ra - b2, 0))
                fb = np.sqrt(np.maximum(rb * rb - b2, 0))
                return np.maximum(fb - fa, 0)

            if m0 >= 0:
                asc_lo = np.maximum(lo, max(r0, b))
                D = seg(np.minimum(asc_lo, hi), hi)
            else:
                if b <= radii_np[0]:
                    return 1e10
                des_lo = np.maximum(lo, b)
                des_hi = np.minimum(hi, r0)
                D = seg(np.minimum(des_lo, des_hi), des_hi) + seg(
                    np.minimum(des_lo, hi), hi
                )
            return float(D @ sigma_np)

        rng = np.random.default_rng(1)
        for _ in range(30):
            r0 = float(rng.uniform(radii_np[0], radii_np[-1]))
            m0 = float(rng.uniform(-1, 1))
            p = jnp.asarray([[0.0, 0.0, r0]])
            w = jnp.asarray([np.sqrt(max(1 - m0 * m0, 0.0)), 0.0, m0])
            te = float(slant_tau_exact(p, w, radii, sigma)[0])
            tt = truth(r0, m0)
            if tt >= 1e9:
                assert te >= 1e9
            else:
                np.testing.assert_allclose(te, tt, rtol=5e-4, atol=1e-7)

    def test_blocked_and_vacuum(self):
        from eradiate_tpu.ops.spherical import slant_tau_exact, TAU_BLOCKED

        R, radii, sigma = self._scene()
        # straight down from 1 km altitude: ground shadow
        p = jnp.asarray([[0.0, 0.0, R + 1.0]])
        tau = float(slant_tau_exact(p, jnp.asarray([0.0, 0.0, -1.0]), radii, sigma)[0])
        assert tau >= TAU_BLOCKED
        # straight up from the top: vacuum
        p = jnp.asarray([[0.0, 0.0, float(radii[-1])]])
        tau = float(slant_tau_exact(p, jnp.asarray([0.0, 0.0, 1.0]), radii, sigma)[0])
        np.testing.assert_allclose(tau, 0.0, atol=1e-7)

    def test_vertical_column(self):
        from eradiate_tpu.ops.spherical import slant_tau_exact

        R, radii, sigma = self._scene()
        p = jnp.asarray([[0.0, 0.0, R]])
        tau = float(slant_tau_exact(p, jnp.asarray([0.0, 0.0, 1.0]), radii, sigma)[0])
        ref = float(jnp.sum(sigma * jnp.diff(radii)))
        np.testing.assert_allclose(tau, ref, rtol=1e-5)


class TestShellFlight:
    """Exact free-flight sampling through shells (the spherical tracers'
    production path; replaces null-collision delta tracking)."""

    def _scene(self):
        R = 6378.0
        z = np.linspace(0, 120, 121)
        radii = R + z
        sigma = 0.012 * np.exp(-z[:-1] / 8.0)
        return R, radii, sigma

    def test_against_numerical_inversion(self):
        import jax
        from eradiate_tpu.ops.spherical import shell_flight

        R, radii, sigma = self._scene()

        def brute(p, d, tau_s, t_max):
            ts = np.linspace(0, float(t_max), 400001)
            r = np.sqrt(np.sum((p[None] + ts[:, None] * d[None]) ** 2, axis=1))
            idx = np.clip(
                np.searchsorted(radii, r, side="right") - 1, 0, len(sigma) - 1
            )
            sig = np.where((r >= radii[0]) & (r <= radii[-1]), sigma[idx], 0.0)
            ctau = np.concatenate(
                [[0.0], np.cumsum(0.5 * (sig[1:] + sig[:-1]) * np.diff(ts))]
            )
            if tau_s >= ctau[-1]:
                return None
            return float(np.interp(tau_s, ctau, ts))

        f = jax.jit(
            lambda p, d, tm, ts: shell_flight(
                p, d, tm,
                jnp.asarray(radii, jnp.float32),
                jnp.asarray(sigma, jnp.float32), ts,
            )
        )
        rng = np.random.default_rng(4)
        n_col = n_esc = 0
        for _ in range(25):
            r0 = rng.uniform(R, R + 120)
            mu = rng.uniform(-1, 1)
            p = np.array([0.0, 0.0, r0])
            d = np.array([np.sqrt(1 - mu * mu), 0.0, mu])
            # t_max: march to ground/top
            tg = np.linspace(0, 3000, 300001)
            r = np.sqrt(np.sum((p[None] + tg[:, None] * d[None]) ** 2, axis=1))
            hit_g = r < radii[0]
            above = r > radii[-1] + 1e-9
            t_max = (
                tg[np.argmax(hit_g)] if hit_g.any()
                else (tg[np.argmax(above)] if above.any() else 3000.0)
            ) or 3000.0
            tau_s = rng.exponential(0.08)
            col, t_col, layer = (
                np.asarray(v)
                for v in f(
                    jnp.asarray(p[None], jnp.float32),
                    jnp.asarray(d[None], jnp.float32),
                    jnp.asarray([t_max], jnp.float32),
                    jnp.asarray([tau_s], jnp.float32),
                )
            )
            tb = brute(p, d, tau_s, t_max)
            if tb is None:
                assert not col[0]
                n_esc += 1
            else:
                assert col[0]
                assert abs(t_col[0] - tb) < 0.05  # km; brute grid resolution
                r_col = np.linalg.norm(p + float(t_col[0]) * d)
                k_ref = int(np.clip(
                    np.searchsorted(radii, r_col, side="right") - 1,
                    0, len(sigma) - 1,
                ))
                assert abs(int(layer[0]) - k_ref) <= 1
                n_col += 1
        assert n_col >= 5 and n_esc >= 5

    def test_transmittance_consistency(self):
        """P(no collision) must equal exp(-slant tau) — the flight and the
        NEE transmittance share one geometry."""
        import jax
        from eradiate_tpu.ops.spherical import shell_flight, slant_tau_exact

        R, radii, sigma = self._scene()
        radii_j = jnp.asarray(radii, jnp.float32)
        sigma_j = jnp.asarray(sigma, jnp.float32)
        p = jnp.asarray([[0.0, 0.0, R]], jnp.float32)
        mu = 0.3
        d = jnp.asarray([np.sqrt(1 - mu * mu), 0.0, mu], jnp.float32)
        tau_ref = float(slant_tau_exact(p, d, radii_j, sigma_j)[0])
        # flight escapes iff tau_s >= tau(t_exit)
        t_max = jnp.asarray([3000.0], jnp.float32)
        eps = 1e-4
        for tau_s, expect in [(tau_ref * (1 - eps) - 1e-6, True),
                              (tau_ref * (1 + eps) + 1e-6, False)]:
            col, _, _ = shell_flight(
                p, jnp.asarray(d)[None, :], t_max, radii_j, sigma_j,
                jnp.asarray([tau_s], jnp.float32),
            )
            assert bool(np.asarray(col)[0]) == expect, (tau_s, tau_ref)


class TestSphericalRegenInvariance:
    """Spherical estimates are invariant to the lane/quota decomposition
    (regen keys depend only on (pixel, global sample id))."""

    def test_lane_plan_invariance(self, monkeypatch, mode_mono):
        import eradiate_tpu.ops.tracer as T

        def run():
            exp = AtmosphereExperiment(
                geometry={"type": "spherical_shell"},
                illumination={"type": "directional", "zenith": 40.0},
                measures={
                    "type": "mdistant", "construct": "hplane",
                    "zeniths": [-30.0, 0.0, 30.0], "azimuth": 0.0,
                    "spp": 64, "id": "m",
                },
                surface={"type": "lambertian", "reflectance": 0.4},
                atmosphere={"type": "molecular"},
            )
            eradiate_tpu.root_seed_state.reset(7)
            return eradiate_tpu.run(exp)["brf"].values

        ref = run()
        monkeypatch.setattr(T, "REGEN_LANES_TARGET", 16)  # quota > 1
        alt = run()
        np.testing.assert_allclose(ref, alt, rtol=1e-4)
