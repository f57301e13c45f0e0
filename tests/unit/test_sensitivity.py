"""Forward-mode sensitivity module (eradiate_tpu.sensitivity).

Pins the estimator contract: detached JVP == common-random-number
finite differences for throughput channels (with RR disabled both
ways), exact linearity/invariance identities, and the documented
refusal of the biased extinction channel.
"""

import dataclasses

import numpy as np
import pytest

import eradiate_tpu as ert
from eradiate_tpu.experiments import AtmosphereExperiment
from eradiate_tpu.sensitivity import channel_names, sensitivities


def _make(rho=0.5, spp=512, surface=None):
    return AtmosphereExperiment(
        illumination={"type": "directional", "zenith": 30.0, "azimuth": 0.0},
        measures={
            "type": "mdistant",
            "construct": "hplane",
            "zeniths": np.linspace(-60, 60, 3),
            "azimuth": 0.0,
            "spp": spp,
        },
        surface=surface or {"type": "lambertian", "reflectance": rho},
        atmosphere={"type": "molecular"},
    )


def _render_norr(exp, scene, sensor, config, spp, seed):
    config = dataclasses.replace(config, rr_depth=config.max_depth)
    return np.asarray(
        exp._render_one(scene, sensor, config, spp, seed, mesh=None)[
            "radiance"
        ]
    )


@pytest.fixture(autouse=True)
def _mode():
    ert.set_mode("mono_single")


class TestThroughputChannels:
    def test_reflectance_matches_crn_fd(self):
        """With RR off and parameter-free direction sampling the
        per-sample estimator is smooth in rho, so a small-eps CRN
        centered difference must match the JVP tightly even at low
        spp."""
        import jax.numpy as jnp

        exp = _make(spp=512)
        res = sensitivities(exp, wrt=["surface.reflectance"], seed=7)
        jvp = res[exp.measures[0].id]["jac"]["surface.reflectance"][
            "radiance"
        ]

        m = exp.measures[0]
        ctx = exp.spectral_context(m)
        scene, sensor, config = exp.compile_scene(m, ctx)
        eps = 1e-3

        def at(drho):
            params = dict(scene.surface.params)
            params["reflectance"] = params["reflectance"] + drho
            s = dataclasses.replace(
                scene, surface=dataclasses.replace(scene.surface,
                                                   params=params)
            )
            return _render_norr(exp, s, sensor, config, 512, 7)

        fd = (at(+eps) - at(-eps)) / (2 * eps)
        np.testing.assert_allclose(jvp, fd, rtol=5e-3, atol=5e-4)

    def test_rpv_shape_parameter(self):
        """BSDF shape parameters (here RPV k) differentiate cleanly."""
        exp = _make(
            surface={"type": "rpv", "rho_0": 0.18, "k": 0.75, "g": -0.1}
        )
        res = sensitivities(exp, wrt=["surface.k", "surface.rho_0"], seed=3)
        e = res[exp.measures[0].id]
        assert np.all(np.isfinite(e["jac"]["surface.k"]["radiance"]))
        # brighter rho_0 -> brighter signal, everywhere
        assert np.all(e["jac"]["surface.rho_0"]["radiance"] > 0)

    def test_albedo_channel_sign(self):
        exp = _make()
        res = sensitivities(exp, wrt=["medium.albedo"], seed=1)
        d = res[exp.measures[0].id]["jac"]["medium.albedo"]["radiance"]
        # more scattering albedo over a rho=0.5 surface cannot darken the
        # TOA signal at 550 nm (Rayleigh albedo is already ~1; the
        # derivative is small but positive)
        assert np.all(d > 0)


class TestExactIdentities:
    def test_irradiance_scale_linearity_and_brf_invariance(self):
        exp = _make(spp=256)
        res = sensitivities(
            exp, wrt=["illumination.irradiance_scale"], seed=0
        )
        e = res[exp.measures[0].id]
        # radiance is exactly linear in the emitter scale
        np.testing.assert_allclose(
            e["jac"]["illumination.irradiance_scale"]["radiance"],
            e["radiance"],
            rtol=1e-6,
        )
        # BRF is exactly invariant (quotient rule cancels)
        np.testing.assert_allclose(
            e["jac"]["illumination.irradiance_scale"]["brf"], 0.0,
            atol=1e-7,
        )

    def test_value_matches_plain_render(self):
        """The sensitivity primal equals a plain (RR-off) render at the
        same seed."""
        exp = _make(spp=256)
        res = sensitivities(exp, wrt=["surface.reflectance"], seed=5)
        m = exp.measures[0]
        ctx = exp.spectral_context(m)
        scene, sensor, config = exp.compile_scene(m, ctx)
        plain = _render_norr(exp, scene, sensor, config, 256, 5)
        np.testing.assert_allclose(res[m.id]["radiance"], plain, rtol=1e-6)


class TestTauChannel:
    def test_tau_scale_matches_analytic_absorber(self):
        """Pure absorber over a Lambertian surface: the direct signal is
        L = (rho/pi) mu0 E exp(-tau/mu0 - tau/mu), so the relative
        derivative w.r.t. a tau scale is exactly -tau (1/mu0 + 1/mu).
        Under the likelihood-ratio estimator every surviving sample
        carries the same tangent ratio, so the JVP is zero-variance and
        must hit the closed form to float precision. (A CRN finite
        difference cannot validate this channel: stop_gradient detaches
        tangents, not primal evaluation, so FD still resamples the
        perturbed medium — use this analytic gate instead.)"""
        tau = 0.4
        exp = AtmosphereExperiment(
            illumination={"type": "directional", "zenith": 30.0,
                          "azimuth": 0.0},
            measures={"type": "mdistant", "construct": "hplane",
                      "zeniths": np.array([-45.0, 0.0, 45.0]),
                      "azimuth": 0.0, "spp": 4096},
            surface={"type": "lambertian", "reflectance": 0.5},
            atmosphere={"type": "homogeneous", "top": 10.0,
                        "sigma_s": 0.0, "sigma_a": tau / 10.0},
        )
        res = sensitivities(exp, wrt=["medium.tau_scale"], seed=4)
        e = res[exp.measures[0].id]
        mu0 = np.cos(np.radians(30.0))
        mus = np.cos(np.radians([45.0, 0.0, 45.0]))
        rel = (
            e["jac"]["medium.tau_scale"]["radiance"] / e["radiance"]
        ).ravel()
        np.testing.assert_allclose(
            rel, -tau * (1.0 / mu0 + 1.0 / mus), rtol=1e-4
        )

    def test_tau_scale_sign_with_scattering(self):
        """Conservative Rayleigh over a bright surface: the naive
        (attached-inversion) estimator reported a spurious smooth
        -0.026; the likelihood-ratio estimator must NOT reproduce that
        sign-level bias (true value is ~0 to slightly positive at
        forward angles — bounded well above the biased value)."""
        exp = _make(spp=8192)
        res = sensitivities(exp, wrt=["medium.tau_scale"], seed=9)
        d = res[exp.measures[0].id]["jac"]["medium.tau_scale"][
            "radiance"
        ].ravel()
        assert np.all(d > -0.015), d

    def test_lr_flight_primal_bit_identical(self):
        """The lr_flight estimator changes production output by ZERO
        bits — the correction factors are primal-neutral."""
        exp = _make(spp=256)
        m = exp.measures[0]
        ctx = exp.spectral_context(m)
        scene, sensor, config = exp.compile_scene(m, ctx)
        off = np.asarray(
            exp._render_one(scene, sensor, config, 256, 3, mesh=None)[
                "radiance"
            ]
        )
        config_lr = dataclasses.replace(config, lr_flight=True)
        on = np.asarray(
            exp._render_one(scene, sensor, config_lr, 256, 3, mesh=None)[
                "radiance"
            ]
        )
        assert np.array_equal(off, on)

    def test_layer_channels_sum_to_total(self):
        """The per-layer weighting-function decomposition (custom
        channels, docs example) must sum exactly to the tau_scale
        channel — linearity of the JVP in the tangent."""
        import jax.numpy as jnp

        exp = AtmosphereExperiment(
            illumination={"type": "directional", "zenith": 30.0,
                          "azimuth": 0.0},
            measures={"type": "mdistant", "construct": "hplane",
                      "zeniths": np.array([0.0]), "azimuth": 0.0,
                      "spp": 1024},
            surface={"type": "lambertian", "reflectance": 0.5},
            atmosphere={"type": "homogeneous", "top": 10.0,
                        "sigma_s": 0.0, "sigma_a": 0.04},
        )
        m = exp.measures[0]
        scene, _, _ = exp.compile_scene(m, exp.spectral_context(m))
        L = scene.medium.tau_levels.shape[-1] - 1

        def tau_layer_channel(i):
            def apply(scene, theta):
                tl = scene.medium.tau_levels
                dtau = jnp.diff(tl, axis=-1)
                bump = dtau.at[..., i].mul(theta)
                tl2 = tl.at[..., 1:].add(jnp.cumsum(bump, axis=-1))
                med = dataclasses.replace(scene.medium, tau_levels=tl2)
                return dataclasses.replace(scene, medium=med)

            apply.__name__ = f"tau_layer_{i}"
            return apply

        res = sensitivities(
            exp,
            wrt=[tau_layer_channel(i) for i in range(L)]
            + ["medium.tau_scale"],
            seed=2,
        )
        e = res[m.id]
        per_layer = sum(
            e["jac"][f"tau_layer_{i}"]["radiance"] for i in range(L)
        )
        np.testing.assert_allclose(
            per_layer, e["jac"]["medium.tau_scale"]["radiance"], rtol=1e-4
        )

    def test_spherical_tau_scale_analytic(self):
        """The unpolarized spherical tracer's likelihood-ratio flight
        matches the absorber closed form (plane-parallel formula holds
        to ~1e-3 for a 10 km shell on an Earth-sized planet at these
        angles)."""
        tau = 0.4
        exp = AtmosphereExperiment(
            geometry={"type": "spherical_shell"},
            illumination={"type": "directional", "zenith": 30.0,
                          "azimuth": 0.0},
            measures={"type": "mdistant", "construct": "hplane",
                      "zeniths": np.array([-45.0, 0.0, 45.0]),
                      "azimuth": 0.0, "spp": 2048},
            surface={"type": "lambertian", "reflectance": 0.5},
            atmosphere={"type": "homogeneous", "top": 10.0,
                        "sigma_s": 0.0, "sigma_a": tau / 10.0},
        )
        res = sensitivities(exp, wrt=["medium.tau_scale"], seed=4)
        e = res[exp.measures[0].id]
        mu0 = np.cos(np.radians(30.0))
        mus = np.cos(np.radians([45.0, 0.0, 45.0]))
        rel = (
            e["jac"]["medium.tau_scale"]["radiance"] / e["radiance"]
        ).ravel()
        np.testing.assert_allclose(
            rel, -tau * (1.0 / mu0 + 1.0 / mus), rtol=3e-3
        )

    def test_spherical_polarized_tau_scale_analytic(self):
        """Round 5 (VERDICT r4 task #5a): the spherical POLARIZED tracer
        grew the likelihood-ratio flight — the last tracer family
        without it. Same absorber closed form as the scalar twin (a pure
        absorber leaves light unpolarized, so the I component obeys the
        scalar formula exactly)."""
        ert.set_mode("mono_polarized_single")
        try:
            tau = 0.4
            exp = AtmosphereExperiment(
                geometry={"type": "spherical_shell"},
                illumination={"type": "directional", "zenith": 30.0,
                              "azimuth": 0.0},
                measures={"type": "mdistant", "construct": "hplane",
                          "zeniths": np.array([-45.0, 0.0, 45.0]),
                          "azimuth": 0.0, "spp": 2048},
                surface={"type": "lambertian", "reflectance": 0.5},
                atmosphere={"type": "homogeneous", "top": 10.0,
                            "sigma_s": 0.0, "sigma_a": tau / 10.0},
            )
            res = sensitivities(exp, wrt=["medium.tau_scale"], seed=4)
            e = res[exp.measures[0].id]
            mu0 = np.cos(np.radians(30.0))
            mus = np.cos(np.radians([45.0, 0.0, 45.0]))
            # radiance is the Stokes I component for polarized measures
            rad = e["radiance"]
            jac = e["jac"]["medium.tau_scale"]["radiance"]
            if rad.ndim == 3:  # [S, P, 4] Stokes layout
                rad, jac = rad[..., 0], jac[..., 0]
            rel = (jac / rad).ravel()
            np.testing.assert_allclose(
                rel, -tau * (1.0 / mu0 + 1.0 / mus), rtol=3e-3
            )
        finally:
            ert.set_mode("mono_single")

    def test_spherical_polarized_lr_primal_bit_identical(self):
        """lr_flight must change spherical-polarized production output
        by ZERO bits (primal-neutral correction factors)."""
        ert.set_mode("mono_polarized_single")
        try:
            exp = AtmosphereExperiment(
                geometry={"type": "spherical_shell"},
                illumination={"type": "directional", "zenith": 50.0,
                              "azimuth": 0.0},
                measures={"type": "mdistant", "construct": "hplane",
                          "zeniths": np.linspace(-40, 40, 3),
                          "azimuth": 0.0, "spp": 256},
                surface={"type": "lambertian", "reflectance": 0.4},
                atmosphere={"type": "molecular"},
            )
            m = exp.measures[0]
            ctx = exp.spectral_context(m)
            scene, sensor, config = exp.compile_scene(m, ctx)
            # the lr path skips the sun-tau table — compare against the
            # exact-slant config so only lr_flight differs
            med = dataclasses.replace(
                scene.medium, sun_tau=None, mu_grid=None
            )
            scene = dataclasses.replace(scene, medium=med)
            off = np.asarray(
                exp._render_one(scene, sensor, config, 256, 3,
                                mesh=None)["radiance"]
            )
            config_lr = dataclasses.replace(config, lr_flight=True)
            on = np.asarray(
                exp._render_one(scene, sensor, config_lr, 256, 3,
                                mesh=None)["radiance"]
            )
            assert np.array_equal(off, on)
        finally:
            ert.set_mode("mono_single")


def _make_canopy(spp=512, leaf_refl=0.45, leaf_trans=0.25):
    from eradiate_tpu.experiments import CanopyExperiment

    return CanopyExperiment(
        canopy={"type": "leaf_cloud", "construct": "cuboid",
                "n_leaves": 200, "leaf_radius": 0.12,
                "l_horizontal": 10.0, "l_vertical": 2.0,
                "leaf_reflectance": leaf_refl,
                "leaf_transmittance": leaf_trans, "seed": 5},
        illumination={"type": "directional", "zenith": 30.0,
                      "azimuth": 0.0},
        measures={"type": "mdistant", "construct": "hplane",
                  "zeniths": np.array([-30.0, 0.0, 30.0]),
                  "azimuth": 0.0, "spp": spp},
        surface={"type": "lambertian", "reflectance": 0.3},
    )


class TestCanopyChannels:
    """Round 5 (VERDICT r4 task #5b): canopy experiments differentiate
    through their dedicated render dispatch instead of being refused."""

    def test_leaf_reflectance_matches_crn_fd(self):
        """canopy.reflectance JVP vs a CRN centered difference through
        the SAME compiled path (perturbing the compiled leaf_params
        directly). The likelihood-ratio side sampling makes the JVP the
        expectation-correct estimator; CRN-FD at a moderate eps carries
        the same smooth part plus rare-flip terms, so agreement is
        asserted at FD-noise tolerance."""
        exp = _make_canopy(spp=4096)
        res = sensitivities(exp, wrt=["canopy.reflectance"], seed=11)
        m = exp.measures[0]
        jvp = res[m.id]["jac"]["canopy.reflectance"]["radiance"]
        assert np.all(np.isfinite(jvp))
        # brighter leaves cannot darken the TOA signal
        assert np.all(jvp > 0)

        ctx = exp.spectral_context(m)
        (scene, sensor, config, leaf_params, leaves, tris,
         tri_params) = exp.compile_canopy_scene(m, ctx)
        config = dataclasses.replace(config, rr_depth=config.max_depth)
        eps = 0.02

        def at(d):
            lp = dict(leaf_params)
            lp["reflectance"] = lp["reflectance"] + d
            raw = exp._render_canopy_raw(
                scene, lp, leaves, sensor, config, 4096, 11, None,
                tris, tri_params,
            )
            return np.asarray(raw["radiance"])

        fd = (at(+eps) - at(-eps)) / (2 * eps)
        np.testing.assert_allclose(jvp, fd, rtol=0.15, atol=2e-3)

    def test_leaf_channels_primal_matches_plain_render(self):
        """The sensitivity primal equals a plain RR-off canopy render at
        the same seed (the LR side-sampling correction is bit-neutral)."""
        exp = _make_canopy(spp=256)
        res = sensitivities(exp, wrt=["canopy.transmittance"], seed=3)
        m = exp.measures[0]
        ctx = exp.spectral_context(m)
        (scene, sensor, config, leaf_params, leaves, tris,
         tri_params) = exp.compile_canopy_scene(m, ctx)
        config = dataclasses.replace(config, rr_depth=config.max_depth,
                                     lr_flight=True)
        raw = exp._render_canopy_raw(
            scene, leaf_params, leaves, sensor, config, 256, 3, None,
            tris, tri_params,
        )
        np.testing.assert_allclose(
            res[m.id]["radiance"], np.asarray(raw["radiance"]), rtol=1e-6
        )

    def test_surface_channel_through_canopy(self):
        """Ground reflectance differentiates under the canopy dispatch."""
        exp = _make_canopy(spp=1024)
        res = sensitivities(exp, wrt=["surface.reflectance"], seed=2)
        d = res[exp.measures[0].id]["jac"]["surface.reflectance"][
            "radiance"
        ]
        assert np.all(np.isfinite(d))
        assert np.all(d > 0)

    def test_canopy_tau_scale_refused(self):
        exp = _make_canopy(spp=64)
        with pytest.raises(ValueError, match="likelihood-ratio"):
            sensitivities(exp, wrt=["medium.tau_scale"])

    def test_leaf_channel_requires_canopy(self):
        exp = _make(spp=64)
        with pytest.raises(ValueError, match="requires a canopy"):
            sensitivities(exp, wrt=["canopy.reflectance"])


class TestGasChannels:
    """Round 5 (VERDICT r4 task #5c): per-species gas concentration
    channels (gas.<species>), linearizing scene compilation host-side
    and riding the likelihood-ratio flight like medium.tau_scale."""

    @staticmethod
    def _absorber_exp(spp=2048, scattering=False):
        from eradiate_tpu.physics.absorption import make_synthetic_mono_db

        db = make_synthetic_mono_db(
            w_nm=np.linspace(500.0, 600.0, 8), base_sigma=5e-3,
            species="H2O",
        )
        return AtmosphereExperiment(
            illumination={"type": "directional", "zenith": 30.0,
                          "azimuth": 0.0},
            measures={"type": "mdistant", "construct": "hplane",
                      "zeniths": np.array([-45.0, 0.0, 45.0]),
                      "azimuth": 0.0, "spp": spp},
            surface={"type": "lambertian", "reflectance": 0.5},
            atmosphere={"type": "molecular", "absorption_data": db,
                        "has_scattering": scattering},
        )

    def test_gas_equals_tau_scale_for_single_absorber(self):
        """With absorption the ONLY extinction and sigma_a exactly
        proportional to x_H2O (the synthetic DB's species axis), scaling
        the H2O column IS scaling tau — the two channels must produce
        the same Jacobian through the same lr-flight machinery."""
        exp = self._absorber_exp()
        res = sensitivities(
            exp, wrt=["gas.H2O", "medium.tau_scale"], seed=6
        )
        e = res[exp.measures[0].id]
        g = e["jac"]["gas.H2O"]["radiance"]
        t = e["jac"]["medium.tau_scale"]["radiance"]
        assert np.all(np.isfinite(g))
        assert np.any(g != 0.0)
        np.testing.assert_allclose(g, t, rtol=1e-4, atol=1e-9)

    def test_gas_channel_with_scattering_sign(self):
        """Against a Rayleigh background, more absorber darkens the TOA
        signal at absorbing wavelengths (throughput + flight terms both
        ride the lr estimator; the derivative must be <= 0 everywhere
        for a rho=0.5 scene dominated by direct transmission)."""
        exp = self._absorber_exp(spp=4096, scattering=True)
        res = sensitivities(exp, wrt=["gas.H2O"], seed=2)
        d = res[exp.measures[0].id]["jac"]["gas.H2O"]["radiance"]
        assert np.all(np.isfinite(d))
        assert np.all(d <= 1e-6)

    def test_gas_channel_unknown_species(self):
        exp = self._absorber_exp(spp=64)
        with pytest.raises(ValueError, match="not in the thermophysical"):
            sensitivities(exp, wrt=["gas.XYZ"], seed=0)

    def test_gas_channel_species_not_in_db(self):
        """AFGL thermoprops carry O3, but the synthetic DB has only an
        H2O axis — attribution to O3 is impossible and must refuse."""
        exp = self._absorber_exp(spp=64)
        with pytest.raises(ValueError, match="not resolvable"):
            sensitivities(exp, wrt=["gas.O3"], seed=0)

    def test_merge_tolerances_restored(self):
        exp = self._absorber_exp(spp=64)
        before = exp.geometry.layer_merge_tol
        sensitivities(exp, wrt=["gas.H2O"], seed=0)
        assert exp.geometry.layer_merge_tol == before


def _make_dem(surface, atmosphere, spp=512,
              zeniths=(-45.0, 0.0, 45.0)):
    from eradiate_tpu.experiments import DEMExperiment

    return DEMExperiment(
        illumination={"type": "directional", "zenith": 30.0,
                      "azimuth": 0.0},
        measures={"type": "mdistant", "construct": "hplane",
                  "zeniths": np.array(zeniths), "azimuth": 0.0,
                  "spp": spp},
        surface=surface,
        atmosphere=atmosphere,
    )


class TestDEMChannels:
    """DEM experiments differentiate through render_dem with the
    terrain attached (round 5, VERDICT r4 task #5 stretch): the DEM
    tracer implements the likelihood-ratio flight, with terrain hits
    carrying their own exp(-(tau_path - sg(tau_path))) event weight, so
    throughput AND extinction channels are available over terrain."""

    def test_dem_tau_scale_analytic_flat(self):
        """Flat zero-elevation terrain over a pure absorber reduces the
        DEM estimator to the plane-parallel closed form: relative
        d/d(tau scale) = -tau (1/mu0 + 1/mu). The terrain-hit
        likelihood-ratio weight carries the -tau/mu leg; NEE
        transmittance carries -tau/mu0; the JVP is zero-variance and
        must hit the closed form to float precision."""
        from eradiate_tpu.scenes.surface import DEMSurface

        tau = 0.4
        surf = DEMSurface(
            elevation=np.zeros((8, 8)), x0=-50.0, y0=-50.0,
            bsdf={"type": "lambertian", "reflectance": 0.5},
        )
        exp = _make_dem(
            surf,
            {"type": "homogeneous", "top": 10.0, "sigma_s": 0.0,
             "sigma_a": tau / 10.0},
            spp=2048,
        )
        res = sensitivities(exp, wrt=["medium.tau_scale"], seed=4)
        e = res[exp.measures[0].id]
        mu0 = np.cos(np.radians(30.0))
        mus = np.cos(np.radians([45.0, 0.0, 45.0]))
        rel = (
            e["jac"]["medium.tau_scale"]["radiance"] / e["radiance"]
        ).ravel()
        np.testing.assert_allclose(
            rel, -tau * (1.0 / mu0 + 1.0 / mus), rtol=1e-4
        )

    def test_dem_tau_scale_analytic_triangulated(self):
        """Same closed form through the triangulated (Moeller-Trumbore)
        terrain path — the likelihood-ratio weights are shared by both
        intersectors inside _make_bounce_dem."""
        from eradiate_tpu.scenes.surface import DEMSurface

        tau = 0.3
        surf = DEMSurface(
            elevation=np.zeros((6, 6)), x0=-50.0, y0=-50.0,
            bsdf={"type": "lambertian", "reflectance": 0.5},
            triangulate=True,
        )
        exp = _make_dem(
            surf,
            {"type": "homogeneous", "top": 10.0, "sigma_s": 0.0,
             "sigma_a": tau / 10.0},
            spp=512, zeniths=(0.0, 45.0),
        )
        res = sensitivities(exp, wrt=["medium.tau_scale"], seed=2)
        e = res[exp.measures[0].id]
        mu0 = np.cos(np.radians(30.0))
        mus = np.cos(np.radians([0.0, 45.0]))
        rel = (
            e["jac"]["medium.tau_scale"]["radiance"] / e["radiance"]
        ).ravel()
        np.testing.assert_allclose(
            rel, -tau * (1.0 / mu0 + 1.0 / mus), rtol=1e-4
        )

    def test_dem_reflectance_matches_crn_fd(self):
        """Throughput channel over a Gaussian hill: detached JVP ==
        common-random-number centered difference through the same DEM
        dispatch (RR off both ways)."""
        import dataclasses

        from eradiate_tpu.core.modes import mode
        from eradiate_tpu.ops.tracer_dem import render_dem
        from eradiate_tpu.scenes.surface import DEMSurface

        surf = DEMSurface.gaussian_hill(
            height_km=0.5, sigma_km=2.0, extent_km=10.0, n=33,
            bsdf={"type": "lambertian", "reflectance": 0.4},
        )
        exp = _make_dem(surf, {"type": "molecular"}, spp=512)
        res = sensitivities(exp, wrt=["surface.reflectance"], seed=7)
        jvp = res[exp.measures[0].id]["jac"]["surface.reflectance"][
            "radiance"
        ]

        m = exp.measures[0]
        ctx = exp.spectral_context(m)
        scene, sensor, config = exp.compile_scene(m, ctx)
        config = dataclasses.replace(config, rr_depth=config.max_depth)
        dem = exp.surface.dem_arrays(dtype=mode().device_dtype)
        eps = 1e-3

        def at(drho):
            params = dict(scene.surface.params)
            params["reflectance"] = params["reflectance"] + drho
            s = dataclasses.replace(
                scene,
                surface=dataclasses.replace(scene.surface, params=params),
            )
            return np.asarray(
                render_dem(s, dem, sensor, config, 512, 7)["radiance"]
            )

        fd = (at(+eps) - at(-eps)) / (2 * eps)
        np.testing.assert_allclose(jvp, fd, rtol=5e-3, atol=5e-4)

    def test_dem_lr_flight_primal_bit_identical(self):
        """lr_flight changes DEM production output by ZERO bits — the
        collision and terrain-hit correction factors are primal-neutral
        (exercised over a hill so terrain hits occur mid-slab)."""
        import dataclasses

        from eradiate_tpu.core.modes import mode
        from eradiate_tpu.ops.tracer_dem import render_dem
        from eradiate_tpu.scenes.surface import DEMSurface

        surf = DEMSurface.gaussian_hill(
            height_km=1.0, sigma_km=2.0, extent_km=10.0, n=17,
            bsdf={"type": "lambertian", "reflectance": 0.4},
        )
        exp = _make_dem(surf, {"type": "molecular"}, spp=256)
        m = exp.measures[0]
        ctx = exp.spectral_context(m)
        scene, sensor, config = exp.compile_scene(m, ctx)
        dem = exp.surface.dem_arrays(dtype=mode().device_dtype)
        off = np.asarray(
            render_dem(scene, dem, sensor, config, 256, 3)["radiance"]
        )
        on = np.asarray(
            render_dem(
                scene, dem, sensor,
                dataclasses.replace(config, lr_flight=True), 256, 3,
            )["radiance"]
        )
        assert np.array_equal(off, on)

    def test_dem_sharded_jacobian_equals_single_device(self):
        """DEM sensitivities ride the sharded render path like the base
        dispatch: global-sample-id seeding makes the mesh Jacobian
        EQUAL the single-device one."""
        from eradiate_tpu.parallel import make_render_mesh
        from eradiate_tpu.scenes.surface import DEMSurface

        surf = DEMSurface.gaussian_hill(
            height_km=0.5, sigma_km=2.0, extent_km=10.0, n=17,
            bsdf={"type": "lambertian", "reflectance": 0.4},
        )

        def make():
            return _make_dem(surf, {"type": "molecular"}, spp=512,
                             zeniths=(0.0, 45.0))

        wrt = ["surface.reflectance", "medium.tau_scale"]
        res_m = sensitivities(make(), wrt=wrt, seed=6,
                              mesh=make_render_mesh(1, 8))
        res_1 = sensitivities(make(), wrt=wrt, seed=6)
        e_m = next(iter(res_m.values()))
        e_1 = next(iter(res_1.values()))
        np.testing.assert_allclose(
            e_m["radiance"], e_1["radiance"], rtol=1e-5
        )
        for ch in wrt:
            np.testing.assert_allclose(
                e_m["jac"][ch]["radiance"], e_1["jac"][ch]["radiance"],
                rtol=1e-4, atol=1e-7,
            )


class TestScopeAndErrors:

    def test_unknown_dispatch_refused(self):
        """Experiment subclasses overriding process() with a dispatch
        sensitivities() does not reflect would silently render through
        the base path — plausible wrong Jacobians — so they are refused
        loudly. (Canopy and DEM dispatches are supported; this guard
        protects third-party overrides.)"""

        class ThirdPartyExperiment(AtmosphereExperiment):
            def process(self, *args, **kwargs):
                return super().process(*args, **kwargs)

        exp = ThirdPartyExperiment(
            illumination={"type": "directional", "zenith": 30.0,
                          "azimuth": 0.0},
            measures={"type": "mdistant", "construct": "hplane",
                      "zeniths": np.array([0.0]), "azimuth": 0.0,
                      "spp": 16},
            surface={"type": "lambertian", "reflectance": 0.3},
            atmosphere=None,
        )
        with pytest.raises(NotImplementedError,
                           match="ThirdPartyExperiment"):
            sensitivities(exp, wrt=["surface.reflectance"])

    def test_unknown_channel(self):
        exp = _make(spp=64)
        with pytest.raises(ValueError, match="unknown sensitivity channel"):
            sensitivities(exp, wrt=["medium.banana"])

    def test_unknown_surface_param(self):
        exp = _make(spp=64)
        with pytest.raises(KeyError, match="not in compiled scene"):
            sensitivities(exp, wrt=["surface.banana"])

    def test_channel_names(self):
        exp = _make(spp=64)
        m = exp.measures[0]
        scene, _, _ = exp.compile_scene(m, exp.spectral_context(m))
        names = channel_names(scene)
        assert "surface.reflectance" in names
        assert "medium.albedo" in names
        assert "medium.tau_scale" in names


class TestOtherModes:
    def test_ckd_mode(self):
        """CKD spectral batching differentiates per (band, g) row."""
        ert.set_mode("ckd_single")
        try:
            exp = AtmosphereExperiment(
                illumination={"type": "directional", "zenith": 30.0,
                              "azimuth": 0.0},
                measures={"type": "mdistant", "construct": "hplane",
                          "zeniths": np.array([0.0, 45.0]),
                          "azimuth": 0.0, "spp": 128,
                          "srf": "sentinel_2a-msi-4"},
                surface={"type": "lambertian", "reflectance": 0.5},
                atmosphere={"type": "molecular"},
            )
            res = sensitivities(exp, wrt=["surface.reflectance"], seed=1)
            d = res[exp.measures[0].id]["jac"]["surface.reflectance"][
                "radiance"
            ]
            assert d.shape[0] > 1 and np.all(np.isfinite(d))
            assert np.all(d > 0)
        finally:
            ert.set_mode("mono_single")

    def test_polarized_mode(self):
        """Polarized transport differentiates (intensity channel);
        surface channels are throughput-type there too."""
        ert.set_mode("mono_polarized_single")
        try:
            exp = _make(spp=128)
            res = sensitivities(exp, wrt=["surface.reflectance"], seed=1)
            d = res[exp.measures[0].id]["jac"]["surface.reflectance"][
                "radiance"
            ]
            assert np.all(np.isfinite(d)) and np.all(d > 0.3)
        finally:
            ert.set_mode("mono_single")

    def test_polarized_tau_scale_analytic(self):
        """The polarized tracer's likelihood-ratio flight hits the same
        closed-form absorber derivative (and the flag is bit-identical
        in primal, checked by the polarized parity tests)."""
        ert.set_mode("mono_polarized_single")
        try:
            tau = 0.4
            exp = AtmosphereExperiment(
                illumination={"type": "directional", "zenith": 30.0,
                              "azimuth": 0.0},
                measures={"type": "mdistant", "construct": "hplane",
                          "zeniths": np.array([-45.0, 0.0, 45.0]),
                          "azimuth": 0.0, "spp": 2048},
                surface={"type": "lambertian", "reflectance": 0.5},
                atmosphere={"type": "homogeneous", "top": 10.0,
                            "sigma_s": 0.0, "sigma_a": tau / 10.0},
            )
            res = sensitivities(exp, wrt=["medium.tau_scale"], seed=4)
            e = res[exp.measures[0].id]
            mu0 = np.cos(np.radians(30.0))
            mus = np.cos(np.radians([45.0, 0.0, 45.0]))
            rel = (
                e["jac"]["medium.tau_scale"]["radiance"] / e["radiance"]
            ).ravel()
            np.testing.assert_allclose(
                rel, -tau * (1.0 / mu0 + 1.0 / mus), rtol=1e-4
            )
        finally:
            ert.set_mode("mono_single")


class TestShardedSensitivities:
    def test_sharded_jacobian_equals_single_device(self):
        """The tangent rides the sharded render's shard_map/collectives;
        global-sample-id seeding makes sharded Jacobians EQUAL
        single-device ones (same contract as values)."""
        from eradiate_tpu.parallel import make_render_mesh

        exp = _make(spp=1024)
        mesh = make_render_mesh(1, 8)
        res_m = sensitivities(
            exp, wrt=["surface.reflectance", "medium.tau_scale"],
            seed=6, mesh=mesh,
        )
        res_1 = sensitivities(
            exp, wrt=["surface.reflectance", "medium.tau_scale"], seed=6
        )
        e_m = res_m[exp.measures[0].id]
        e_1 = res_1[exp.measures[0].id]
        np.testing.assert_allclose(
            e_m["radiance"], e_1["radiance"], rtol=1e-5
        )
        for ch in ("surface.reflectance", "medium.tau_scale"):
            np.testing.assert_allclose(
                e_m["jac"][ch]["radiance"], e_1["jac"][ch]["radiance"],
                rtol=1e-4, atol=1e-7,
            )


class TestSphericalGeometry:
    def test_jvp_through_spherical_tracer(self):
        """The spherical path differentiates (forward mode) through the
        shell flight and the exact slant depth."""
        exp = AtmosphereExperiment(
            geometry={"type": "spherical_shell"},
            illumination={"type": "directional", "zenith": 50.0,
                          "azimuth": 0.0},
            measures={
                "type": "mdistant",
                "construct": "hplane",
                "zeniths": np.linspace(-40, 40, 3),
                "azimuth": 0.0,
                "spp": 128,
            },
            surface={"type": "lambertian", "reflectance": 0.4},
            atmosphere={"type": "molecular"},
        )
        res = sensitivities(exp, wrt=["surface.reflectance"], seed=2)
        e = res[exp.measures[0].id]
        d = e["jac"]["surface.reflectance"]["brf"]
        assert np.all(np.isfinite(d))
        # direct two-way transmittance bounds the reflectance derivative
        assert np.all(d > 0.2) and np.all(d < 1.2)
