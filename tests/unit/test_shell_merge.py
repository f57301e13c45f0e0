"""Unit tests: error-bounded adaptive shell merging + matmul interp fetch."""

import numpy as np
import pytest

import jax.numpy as jnp

from eradiate_tpu.physics.shell_merge import (
    adaptive_shell_groups,
    merge_layer_mean,
    merge_layer_weighted,
)

R = 6378.1


def _profile(L=1200):
    z = np.linspace(0.0, 120.0, L + 1)
    sigma = 0.0113 * np.exp(-0.5 * (z[:-1] + z[1:]) / 8.0)[None, :]
    return z, sigma


class TestAdaptiveGroups:
    def test_identity_when_disabled(self):
        z, sigma = _profile(100)
        g = adaptive_shell_groups(z, sigma, R, 0.0)
        np.testing.assert_array_equal(g, np.arange(101))

    def test_covers_grid(self):
        z, sigma = _profile()
        g = adaptive_shell_groups(z, sigma, R, 1e-3)
        assert g[0] == 0 and g[-1] == 1200
        assert np.all(np.diff(g) >= 1)
        assert g.size - 1 < 400  # actually merges

    def test_vertical_tau_exact(self):
        """The thickness-weighted mean preserves every vertical integral."""
        z, sigma = _profile()
        g = adaptive_shell_groups(z, sigma, R, 3e-3)
        dz = np.diff(z)
        sig_m = merge_layer_mean(sigma, g, dz)
        dz_m = np.diff(z[g])
        np.testing.assert_allclose(
            (sig_m * dz_m).sum(), (sigma * dz).sum(), rtol=1e-12
        )
        # and per group
        for k in range(g.size - 1):
            s = slice(g[k], g[k + 1])
            np.testing.assert_allclose(
                sig_m[0, k] * dz_m[k], (sigma[0, s] * dz[s]).sum(), rtol=1e-12
            )

    def test_slant_tau_error_bounded(self):
        """Worst-case tangent-ray |delta tau| stays under ~tol (measured
        0.7x tol over a 4000-ray fan in the round-4 bring-up)."""
        from eradiate_tpu.ops.spherical import slant_tau_exact

        tol = 3e-3
        z, sigma = _profile()
        g = adaptive_shell_groups(z, sigma, R, tol)
        dz = np.diff(z)
        sig_m = merge_layer_mean(sigma, g, dz)

        rng = np.random.default_rng(0)
        N = 500
        r = R + rng.uniform(0, 120, N)
        mu = np.concatenate(
            [rng.uniform(-1, 1, N // 2), rng.uniform(-0.15, 0.15, N - N // 2)]
        )
        p = np.stack([np.zeros(N), np.zeros(N), r], -1)
        w = np.stack([np.sqrt(np.maximum(1 - mu**2, 0)), np.zeros(N), mu], -1)

        import jax

        f = jax.vmap(
            lambda pp, ww, rr, ss: slant_tau_exact(pp[None], ww, rr, ss)[0],
            in_axes=(0, 0, None, None),
        )
        t_ref = np.asarray(
            f(
                jnp.asarray(p, jnp.float64),
                jnp.asarray(w, jnp.float64),
                jnp.asarray(R + z, jnp.float64),
                jnp.asarray(sigma[0], jnp.float64),
            )
        )
        t_m = np.asarray(
            f(
                jnp.asarray(p, jnp.float64),
                jnp.asarray(w, jnp.float64),
                jnp.asarray(R + z[g], jnp.float64),
                jnp.asarray(sig_m[0], jnp.float64),
            )
        )
        ok = (t_ref < 1e9) & (t_m < 1e9)
        assert np.abs(t_m - t_ref)[ok].max() < 1.5 * tol

    def test_weighted_merge_preserves_scattering_depth(self):
        z, sigma = _profile()
        albedo = np.linspace(0.3, 0.9, sigma.shape[1])[None, :]
        dz = np.diff(z)
        g = adaptive_shell_groups(z, sigma, R, 1e-2)
        w = sigma * dz  # extinction-depth weights (see compile_scene)
        sig_m = merge_layer_mean(sigma, g, dz)
        alb_m = merge_layer_weighted(albedo, g, w)
        dz_m = np.diff(z[g])
        np.testing.assert_allclose(
            (sig_m * alb_m * dz_m).sum(), (sigma * albedo * dz).sum(), rtol=1e-10
        )

    def test_zero_weight_groups_fall_back_to_mean(self):
        z = np.linspace(0, 10, 11)
        sigma = np.zeros((1, 10))
        albedo = np.full((1, 10), 0.7)
        g = adaptive_shell_groups(z, sigma, R, 1e-3)
        w = sigma * albedo * np.diff(z)
        alb_m = merge_layer_weighted(albedo, g, w)
        np.testing.assert_allclose(alb_m, 0.7)


class TestExperimentWiring:
    def test_spherical_compile_merges(self, mode_mono):
        import eradiate_tpu as ert
        from eradiate_tpu.experiments import AtmosphereExperiment
        from eradiate_tpu.scenes.geometry import EARTH_RADIUS_KM

        def build(tol):
            exp = AtmosphereExperiment(
                geometry={"type": "spherical_shell", "shell_merge_tol": tol},
                illumination={"type": "directional", "zenith": 30.0},
                measures={
                    "type": "mdistant",
                    "construct": "hplane",
                    "zeniths": [-30.0, 0.0, 30.0],
                    "azimuth": 0.0,
                    "spp": 4,
                    "target": [0.0, 0.0, EARTH_RADIUS_KM],
                    "id": "m",
                },
                surface={"type": "lambertian", "reflectance": 0.3},
                atmosphere={"type": "molecular"},
            )
            exp.init()
            m = exp.measures[0]
            return exp.compile_scene(m, exp.spectral_context(m))

        scene0, _, _ = build(0.0)
        scene1, _, _ = build(1e-3)
        L0 = scene0.medium.sigma_t.shape[-1]
        L1 = scene1.medium.sigma_t.shape[-1]
        assert L0 == 1200 and L1 < 400
        # vertical optical depth preserved to f32 rounding
        tau0 = float(
            jnp.sum(scene0.medium.sigma_t[0] * jnp.diff(scene0.medium.radii))
        )
        tau1 = float(
            jnp.sum(scene1.medium.sigma_t[0] * jnp.diff(scene1.medium.radii))
        )
        np.testing.assert_allclose(tau1, tau0, rtol=1e-5)
        # per-layer phase params follow the merged grid
        assert scene1.medium.phase_params[0]["depol"].shape[-1] == L1

    def test_merged_brf_matches_unmerged(self, mode_mono):
        """Low-spp MC smoke: merged and unmerged agree within MC noise."""
        import eradiate_tpu as ert
        from eradiate_tpu.experiments import AtmosphereExperiment
        from eradiate_tpu.scenes.geometry import EARTH_RADIUS_KM

        def run(tol, seed):
            ert.root_seed_state.reset(seed)
            exp = AtmosphereExperiment(
                geometry={"type": "spherical_shell", "shell_merge_tol": tol},
                illumination={"type": "directional", "zenith": 45.0},
                measures={
                    "type": "mdistant",
                    "construct": "hplane",
                    "zeniths": [-40.0, 0.0, 40.0],
                    "azimuth": 0.0,
                    "spp": 2048,
                    "target": [0.0, 0.0, EARTH_RADIUS_KM],
                    "id": "m",
                },
                surface={"type": "lambertian", "reflectance": 0.3},
                atmosphere={"type": "molecular"},
            )
            res = ert.run(exp)
            return np.asarray(res["brf"]).ravel()

        b0 = run(0.0, 7)
        b1 = run(1e-3, 7)
        np.testing.assert_allclose(b1, b0, rtol=0.05)


class TestInterpFetchMXU:
    def test_matches_reference_interp(self, monkeypatch):
        """Force the dense/matmul path on CPU and compare against the
        gather-based reference interpolation."""
        import eradiate_tpu.ops.medium as med

        rng = np.random.default_rng(3)
        M = 181
        mu = jnp.asarray(np.linspace(-1, 1, M), jnp.float32)
        vals = jnp.asarray(
            np.exp(rng.normal(size=M)).cumsum() / 40.0, jnp.float32
        )
        x = jnp.asarray(rng.uniform(-1, 1, 2048), jnp.float32)
        i_ref, f_ref, ((a, b),) = med._interp_tables(x, mu, (vals,))
        ref = a + f_ref * (b - a)
        monkeypatch.setattr(med, "_dense_lookup", lambda: True)
        i_new, f_new, ((y0, dy),) = med.interp_fetch(x, mu, (vals,))
        out = y0 + f_new * dy
        assert bool(jnp.all(i_ref == i_new))
        np.testing.assert_allclose(np.asarray(f_new), np.asarray(f_ref))
        np.testing.assert_allclose(
            np.asarray(out), np.asarray(ref), rtol=5e-5, atol=5e-6
        )


class TestPlaneParallelMerge:
    def test_material_boundary_blocks_merging(self):
        """Rows with an abrupt scattering-component change (aerosol layer
        edge) must not merge across the boundary."""
        from eradiate_tpu.physics.shell_merge import adaptive_layer_groups_pp

        z = np.linspace(0.0, 10.0, 101)
        sigma = np.full((1, 100), 0.05)
        aer = np.where(z[:-1] < 2.0, 0.05, 0.0)[None, :]
        rows = np.concatenate([sigma, aer], axis=0)
        g = adaptive_layer_groups_pp(z, rows, 1e-3)
        # the 2-km edge (level index 20) is a group boundary
        assert 20 in g
        # and constant regions merge hard
        assert g.size - 1 < 30

    def test_pp_merge_bit_identical_for_uniform_properties(self, mode_mono):
        """Rayleigh-only plane-parallel: transport lives in the tau
        coordinate and every per-layer quantity is uniform, so the merged
        run is BIT-identical to the raw 1200-layer run."""
        import eradiate_tpu as ert
        from eradiate_tpu.experiments import AtmosphereExperiment

        def run(tol):
            exp = AtmosphereExperiment(
                geometry={"type": "plane_parallel", "layer_merge_tol": tol},
                illumination={"type": "directional", "zenith": 30.0},
                measures={
                    "type": "mdistant",
                    "construct": "hplane",
                    "zeniths": [-45.0, 0.0, 45.0],
                    "azimuth": 0.0,
                    "spp": 512,
                    "id": "m",
                },
                surface={"type": "lambertian", "reflectance": 0.5},
                atmosphere={"type": "molecular"},
            )
            ert.root_seed_state.reset(11)
            return np.asarray(ert.run(exp)["brf"])

        np.testing.assert_array_equal(run(1e-3), run(0.0))

    def test_pp_merge_preserves_columns(self, mode_mono):
        from eradiate_tpu.test_tools.test_cases import (
            create_rpv_afgl1986_continental_brfpp,
        )

        def medium(tol):
            e = create_rpv_afgl1986_continental_brfpp(n_vza=3)
            e.geometry.layer_merge_tol = tol
            e.init()
            m = e.measures[0]
            sc, _, _ = e.compile_scene(m, e.spectral_context(m))
            return sc.medium

        m0 = medium(0.0)
        m1 = medium(1e-3)
        assert m1.albedo.shape[-1] < 100 < m0.albedo.shape[-1]
        # total optical depth exact (tau_levels are cumulative)
        np.testing.assert_allclose(
            float(m1.tau_levels[0, -1]), float(m0.tau_levels[0, -1]), rtol=1e-6
        )


class TestSunTauFetchMXU:

    def test_fast_fetch_matches_exact_slant(self):
        """The round-5 arithmetic-index fetch (uniform radius axis +
        asinh-warped mu axis, single-bf16 weights) agrees with the exact
        closed-form slant depth away from the terminator band, and with
        the table's own bilinear (lookup on the same grid) everywhere —
        pinning both the warp inversion and the hi/lo matmul plumbing."""
        import jax.numpy as jnp

        from eradiate_tpu.ops.spherical import (
            slant_tau_exact,
            sun_mu_grid_warped,
            sun_tau_fetch_fast,
            sun_tau_table_grid,
        )

        R6 = 6378.1
        z = np.linspace(0.0, 100.0, 101)
        radii = jnp.asarray(R6 + z, jnp.float32)
        sigma = jnp.asarray(
            0.012 * np.exp(-z[:-1] / 8.0)[None, :], jnp.float32
        )
        mu_np, warp = sun_mu_grid_warped(128)
        mu_grid = jnp.asarray(mu_np, jnp.float32)
        r_grid = jnp.asarray(np.linspace(R6, R6 + 100.0, 128), jnp.float32)
        table = sun_tau_table_grid(
            sigma, radii, r_grid, mu_grid, r_ground=0.0
        )[0]
        rng = np.random.default_rng(3)
        B = 4096
        r = jnp.asarray(R6 + rng.uniform(0, 100, B), jnp.float32)
        mu = jnp.asarray(rng.uniform(-1.0, 1.0, B), jnp.float32)
        got = np.asarray(sun_tau_fetch_fast(table, r_grid, warp, r, mu))
        smu = jnp.sqrt(jnp.clip(1.0 - mu * mu, 0.0, 1.0))
        p = jnp.stack([jnp.zeros(B), jnp.zeros(B), r], 1)
        w = jnp.stack([smu, jnp.zeros(B), mu], 1)
        ref = np.asarray(
            slant_tau_exact(p, w, radii, sigma[0], r_ground=0.0)
        )
        # production consults the table only off the exact-blocked set;
        # the limb-grazing band (near-horizontal descending, tangent in
        # the lower atmosphere) keeps the documented sqrt-cusp limit —
        # gate it loosely, and the rest tightly
        b = np.asarray(r) * np.asarray(smu)
        band = (np.asarray(mu) < 0.1) & (b - R6 < 30.0)
        ok = ~band
        T_got, T_ref = np.exp(-np.minimum(got, 80)), np.exp(-np.minimum(ref, 80))
        err = np.abs(T_got - T_ref)
        assert err[ok].max() < 5e-3
        assert err[ok].mean() < 2e-4
        assert err.max() < 3e-2  # cusp band itself stays bounded

    def test_matches_lookup_at_off_node_points(self):
        """The two-hot matmul bilinear fetch reproduces the gather-based
        lookup_sun_tau on the same table (the fetch is exact bilinear;
        the table's own terminator-cusp limit is documented in
        performance.md)."""
        import jax.numpy as jnp

        from eradiate_tpu.ops.spherical import (
            lookup_sun_tau,
            sun_mu_grid,
            sun_tau_fetch,
            sun_tau_table,
        )

        R6 = 6378.1
        z = np.linspace(0.0, 100.0, 101)
        radii = jnp.asarray(R6 + z, jnp.float32)
        sigma = jnp.asarray(
            0.012 * np.exp(-z[:-1] / 8.0)[None, :], jnp.float32
        )
        mu_grid = jnp.asarray(sun_mu_grid(), jnp.float32)
        table = sun_tau_table(sigma, radii, mu_grid, r_ground=0.0)[0]
        rng = np.random.default_rng(2)
        r = jnp.asarray(R6 + rng.uniform(0, 100, 300), jnp.float32)
        mu = jnp.asarray(rng.uniform(-0.9, 0.9, 300), jnp.float32)
        ref = np.array(
            [
                float(lookup_sun_tau(table, radii, mu_grid, r[i], mu[i]))
                for i in range(300)
            ]
        )
        got = np.asarray(sun_tau_fetch(table, radii, mu_grid, r, mu))
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
