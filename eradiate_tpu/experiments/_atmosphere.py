"""One-dimensional atmosphere experiment.

Mirror of ``AtmosphereExperiment`` (``src/eradiate/experiments/_atmosphere.py:42``):
surface + 1D atmosphere + directional sun + distant measures. This build
compiles the whole spectral grid into one device batch (SURVEY §7.1
"spectral driver").
"""

from __future__ import annotations

import attrs
import jax.numpy as jnp
import numpy as np

from ..core.modes import mode
from ..ops.scene_state import (
    IlluminationArrays,
    MediumArrays,
    SceneArrays,
    SceneConfig,
    SensorArrays,
    SurfaceArrays,
)
from ..scenes.atmosphere import Atmosphere, MolecularAtmosphere, atmosphere_factory
from ..scenes.geometry import PlaneParallelGeometry, SceneGeometry
from ..scenes.measure import TargetPoint, TargetRectangle
from ..scenes.surface import Surface, surface_converter
from ..spectral.grid import CKDSpectralGrid, MonoSpectralGrid
from ._core import EarthObservationExperiment

__all__ = ["AtmosphereExperiment"]


def _atmosphere_converter(value):
    if value is None:
        return None
    if isinstance(value, dict):
        return atmosphere_factory.convert(value)
    if isinstance(value, Atmosphere):
        return value
    raise TypeError(f"cannot convert {type(value)} to Atmosphere")


@attrs.define(eq=False, slots=False)
class AtmosphereExperiment(EarthObservationExperiment):
    """1D atmosphere experiment (alias of the reference's
    ``OneDimExperiment``)."""

    geometry: SceneGeometry = attrs.field(
        factory=PlaneParallelGeometry, converter=SceneGeometry.convert
    )
    atmosphere: Atmosphere | None = attrs.field(
        factory=lambda: atmosphere_factory.convert({"type": "molecular"}),
        converter=_atmosphere_converter,
    )
    surface: Surface | None = attrs.field(
        default={"type": "lambertian", "reflectance": 0.5},
        converter=lambda v: None if v is None else surface_converter(v),
    )

    def __attrs_post_init__(self):
        # Default measure targets: scene origin for plane-parallel, the
        # sub-sensor surface point for spherical shells (mirror of
        # ``_atmosphere.py:140-163``: TargetPoint([0,0,0]) or [0,0,R]).
        if self.geometry.kind == "spherical_shell":
            z_target = self.geometry.planet_radius + self.geometry.ground_altitude
        else:
            z_target = self.geometry.ground_altitude
        for m in self.measures:
            if m.target is None and m.is_distant:
                m.target = TargetPoint(xyz=np.array([0.0, 0.0, z_target]))

    # -- spectral driver ---------------------------------------------------
    def spectral_grid_for(self, measure):
        m = mode()
        if m.is_mono:
            grid = None
            if (
                isinstance(self.atmosphere, MolecularAtmosphere)
                and self.atmosphere.absorption_data is not None
                and self.atmosphere.absorption_data.kind == "mono"
            ):
                grid = MonoSpectralGrid(self.atmosphere.absorption_data.wavelengths)
            if grid is None:
                grid = MonoSpectralGrid.default()
            return grid.select(measure.srf)
        else:
            grid = None
            db = getattr(self.atmosphere, "absorption_data", None)
            if db is not None and getattr(db, "kind", None) == "ckd":
                grid = db.spectral_grid()
            if grid is None:
                grid = CKDSpectralGrid.default()
            grid = grid.select(measure.srf)
            return grid.walk_quads(self.ckd_quad_config, db)

    def spectral_context(self, measure) -> dict:
        m = mode()
        grid = self.spectral_grid_for(measure)
        if m.is_mono:
            return {"w": grid.wavelengths}
        # CKD: flatten (bin, g) pairs
        ws, gs, bidx, gw = [], [], [], []
        for i in range(len(grid)):
            quad = grid.quad_for_bin(i)
            nodes = quad.eval_nodes((0.0, 1.0))
            # normalized weights on [0, 1]: sum to 1 per bin
            weights = quad.weights / 2.0
            for gnode, wt in zip(nodes, weights):
                ws.append(grid.wcenters[i])
                gs.append(gnode)
                bidx.append(i)
                gw.append(wt)
        return {
            "w": np.asarray(ws),
            "g": np.asarray(gs),
            "bin_index": np.asarray(bidx, dtype=np.int64),
            "g_weights": np.asarray(gw),
            "bin_wcenters": grid.wcenters,
        }

    # -- scene compilation -------------------------------------------------
    def compile_scene(self, measure, spectral_ctx):
        m = mode()
        w = np.asarray(spectral_ctx["w"], dtype=np.float64)
        g = spectral_ctx.get("g")
        S = w.size
        zgrid = self.geometry.zgrid
        L = zgrid.n_layers
        dtype = m.device_dtype

        # Medium
        if self.atmosphere is not None:
            sigma_t = self.atmosphere.eval_sigma_t(w, g, zgrid)
            albedo = self.atmosphere.eval_albedo(w, g, zgrid)
            kinds, params, weights = self.atmosphere.eval_phase(w, zgrid)
        else:
            sigma_t = np.zeros((S, L))
            albedo = np.ones((S, L))
            kinds = ("rayleigh",)
            params = ({"depol": np.zeros((S, L))},)
            weights = np.ones((S, 1, L))

        spherical = self.geometry.kind == "spherical_shell"
        if spherical:
            from ..ops.tracer_spherical import SphericalMediumArrays
            from ..physics.shell_merge import (
                adaptive_shell_groups,
                merge_layer_mean,
                merge_layer_weighted,
            )

            levels = zgrid.levels
            tol = getattr(self.geometry, "shell_merge_tol", None)
            groups = adaptive_shell_groups(
                levels, sigma_t, self.geometry.planet_radius, tol or 0.0
            )
            if groups.size - 1 < np.asarray(sigma_t).shape[-1]:
                # error-bounded merge: vertical tau exact, worst-case
                # tangent slant-tau error <= tol per group (shell_merge.py)
                dz = np.diff(levels)
                sigma_np = np.asarray(sigma_t, dtype=np.float64)
                # albedo merges under extinction-depth weights (sigma dz)
                # so sigma_m * albedo_m * dz_m preserves the vertical
                # scattering depth exactly; phase quantities merge under
                # scattering-depth weights (sigma albedo dz)
                w_ext = sigma_np * dz
                w_scat = w_ext * np.asarray(albedo, dtype=np.float64)
                sigma_t_m = merge_layer_mean(sigma_np, groups, dz)
                albedo = merge_layer_weighted(albedo, groups, w_ext)
                weights = merge_layer_weighted(weights, groups, w_scat[:, None, :])
                L_m = groups.size - 1
                params = tuple(
                    {
                        k: (
                            merge_layer_weighted(v, groups, w_scat)
                            if (
                                np.ndim(v) >= 1
                                and np.shape(v)[-1] == L
                                and np.shape(v)[-1] != L_m
                            )
                            else v
                        )
                        for k, v in p.items()
                    }
                    for p in params
                )
                levels = levels[groups]
                sigma_t = sigma_t_m

            radii = jnp.asarray(
                self.geometry.planet_radius + levels, dtype=dtype
            )
            sig = jnp.asarray(sigma_t, dtype=dtype)
            phase_params_dev = tuple(
                {k: jnp.asarray(v, dtype=dtype) for k, v in p.items()}
                for p in params
            )
            # NEE sun transmittance: precomputed (radius, local cosine)
            # slant-tau table fetched per event via the two-hot matmul
            # bilinear (ops/spherical.sun_tau_fetch) — the round-5
            # ablation measured the exact per-event slant recomputation
            # at 47% of the c4 per-event cost for a max 7.6e-4 relative
            # radiance error from the table (grids: shell levels x
            # horizon-focused sun_mu_grid). f64 modes and disabled-table
            # geometries keep the exact closed form
            # (ops/spherical.slant_tau_exact); sensitivity renders
            # (lr_flight) always use the exact attached slant.
            sun_tau = mu_grid_dev = None
            table_flag = getattr(self.geometry, "sun_tau_table", "auto")
            if table_flag == "auto":
                # terminator-cusp guardrail (see SphericalShellGeometry
                # .sun_tau_table): exact slant at high sun zenith where
                # limb-grazing NEE events carry weight
                table_flag = (
                    getattr(self.illumination, "zenith", 0.0) <= 80.0
                )
            sun_r_grid = sun_mu_warp = None
            if table_flag and np.dtype(dtype) == np.float32:
                from ..ops.spherical import (
                    sun_mu_grid_warped,
                    sun_tau_table_grid,
                )

                # round-5 fast-fetch grids (ops/spherical.
                # sun_tau_fetch_fast): UNIFORM 128-level radius axis and
                # the asinh-warped 128-point mu axis — cell location is
                # arithmetic per event (no compare-sum index reductions)
                # and the [128, 128] hi/lo-bf16 table needs two matmuls
                # instead of three over [233, 226]. Measured vs the
                # exact slant on c4-like event states: p99 |dT| 4.9e-3
                # in the limb band vs 0.12 for the legacy piecewise
                # grids (the warp resolves the terminator band better).
                mu_np, warp = sun_mu_grid_warped(128)
                mu_grid_dev = jnp.asarray(mu_np, dtype=dtype)
                r0g = np.linspace(
                    float(self.geometry.planet_radius + levels[0]),
                    float(self.geometry.planet_radius + levels[-1]),
                    128,
                )
                sun_r_grid = jnp.asarray(r0g, dtype=dtype)
                sun_mu_warp = warp
                # r_ground=0: blockage is NOT baked into the table (it
                # would poison the bilinear near the terminator); the
                # tracers apply the exact cross-product blocked test
                sun_tau = sun_tau_table_grid(
                    sig, radii, sun_r_grid, mu_grid_dev, r_ground=0.0
                )
            medium = SphericalMediumArrays(
                radii=radii,
                sigma_t=sig,
                sigma_majorant=jnp.asarray(
                    np.max(np.asarray(sigma_t), axis=1), dtype=dtype
                ),
                albedo=jnp.asarray(albedo, dtype=dtype),
                phase_weights=jnp.asarray(weights, dtype=dtype),
                phase_params=phase_params_dev,
                sun_tau=sun_tau,
                mu_grid=mu_grid_dev,
                sun_r_grid=sun_r_grid,
                sun_mu_warp=sun_mu_warp,
            )
        else:
            # host-side cumulative tau: scene compilation stays numpy and
            # ships to the device in one transfer per leaf (every eager
            # device op would be a separate dispatch)
            from ..physics.shell_merge import (
                adaptive_layer_groups_pp,
                merge_layer_mean,
                merge_layer_weighted,
            )

            levels = zgrid.levels
            tol = getattr(self.geometry, "layer_merge_tol", None)
            if tol:
                # plane-parallel transport is invariant in the tau
                # coordinate, so layers merge under a slant-error bound;
                # per-component scattering rows block merging across
                # material boundaries (aerosol layer edges)
                sigma_np = np.asarray(sigma_t, dtype=np.float64)
                alb_np = np.asarray(albedo, dtype=np.float64)
                w_np = np.asarray(weights, dtype=np.float64)
                C = w_np.shape[1]
                rows = np.concatenate(
                    [sigma_np]
                    + [sigma_np * alb_np * w_np[:, c, :] for c in range(C)],
                    axis=0,
                )
                groups = adaptive_layer_groups_pp(levels, rows, tol)
                if groups.size - 1 < sigma_np.shape[-1]:
                    dzf = np.diff(levels)
                    w_ext = sigma_np * dzf
                    w_scat = w_ext * alb_np
                    sigma_t = merge_layer_mean(sigma_np, groups, dzf)
                    albedo = merge_layer_weighted(alb_np, groups, w_ext)
                    weights = merge_layer_weighted(
                        w_np, groups, w_scat[:, None, :]
                    )
                    L_m = groups.size - 1
                    params = tuple(
                        {
                            k: (
                                merge_layer_weighted(v, groups, w_scat)
                                if (
                                    np.ndim(v) >= 1
                                    and np.shape(v)[-1] == L
                                    and np.shape(v)[-1] != L_m
                                )
                                else v
                            )
                            for k, v in p.items()
                        }
                        for p in params
                    )
                    levels = levels[groups]

            phase_params_dev = tuple(
                {k: jnp.asarray(v, dtype=dtype) for k, v in p.items()}
                for p in params
            )
            dz = np.diff(levels)
            tau_np = np.concatenate(
                [
                    np.zeros(sigma_t.shape[:-1] + (1,)),
                    np.cumsum(np.asarray(sigma_t) * dz, axis=-1),
                ],
                axis=-1,
            )
            medium = MediumArrays(
                z_levels=jnp.asarray(levels, dtype=dtype),
                tau_levels=jnp.asarray(tau_np, dtype=dtype),
                albedo=jnp.asarray(albedo, dtype=dtype),
                phase_weights=jnp.asarray(weights, dtype=dtype),
                phase_params=phase_params_dev,
            )

        # Surface
        if self.surface is not None:
            surf_kind = self.surface.bsdf_kind
            sparams = {
                k: jnp.asarray(v, dtype=dtype) if not isinstance(v, str) else v
                for k, v in self.surface.eval_bsdf_params(w).items()
            }
        else:
            surf_kind = "black"
            sparams = {}
        surface = SurfaceArrays(params=sparams)

        # Illumination
        from ..scenes.illumination import ConstantIllumination, SpotIllumination

        illumination_kind = "directional"
        if isinstance(self.illumination, SpotIllumination):
            illumination_kind = "spot"
            illum = IlluminationArrays(
                direction=jnp.asarray(self.illumination.direction, dtype=dtype),
                irradiance=jnp.asarray(
                    self.illumination.eval_intensity(w), dtype=dtype
                ),
                cos_cutoff=jnp.asarray(self.illumination.cos_cutoff, dtype=dtype),
                sky_radiance=jnp.zeros(S, dtype=dtype),
                position=jnp.asarray(self.illumination.origin, dtype=dtype),
            )
        elif isinstance(self.illumination, ConstantIllumination):
            illum = IlluminationArrays(
                direction=jnp.asarray([0.0, 0.0, -1.0], dtype=dtype),
                irradiance=jnp.zeros(S, dtype=dtype),
                cos_cutoff=jnp.asarray(1.0, dtype=dtype),
                sky_radiance=jnp.asarray(
                    self.illumination.radiance.eval(w), dtype=dtype
                ),
            )
        else:
            illum = IlluminationArrays(
                direction=jnp.asarray(self.illumination.direction, dtype=dtype),
                irradiance=jnp.asarray(
                    self.illumination.eval_irradiance(w), dtype=dtype
                ),
                cos_cutoff=jnp.asarray(self.illumination.cos_cutoff, dtype=dtype),
                sky_radiance=jnp.zeros(S, dtype=dtype),
            )

        scene = SceneArrays(medium=medium, surface=surface, illumination=illum)

        # Sensor
        anchor = getattr(measure, "ray_anchor", None)
        extent = None
        pixel_targets = getattr(measure, "pixel_targets", None)
        per_pixel = pixel_targets() if callable(pixel_targets) else None
        if anchor is not None:
            # camera-style measures: rays start at the anchor point
            target = np.asarray(anchor, dtype=np.float64)
        elif per_pixel is not None:
            # mpdistant: one target subcell per film pixel
            target, extent = per_pixel
        elif isinstance(measure.target, TargetPoint):
            target = measure.target.xyz
        elif isinstance(measure.target, TargetRectangle):
            r = measure.target
            target = np.array(
                [0.5 * (r.xmin + r.xmax), 0.5 * (r.ymin + r.ymax), r.z]
            )
            extent = np.array([r.xmax - r.xmin, r.ymax - r.ymin])
        else:
            target = np.zeros(3)
        sensor = SensorArrays(
            directions=jnp.asarray(measure.sensor_directions(), dtype=dtype),
            target=jnp.asarray(target, dtype=dtype),
            ray_offset=jnp.asarray(
                np.nan
                if getattr(measure, "ray_offset", None) is None
                else measure.ray_offset,
                dtype=dtype,
            ),
            target_extent=None if extent is None else jnp.asarray(extent, dtype=dtype),
        )

        integrator = self.integrator
        config = SceneConfig(
            geometry=self.geometry.kind,
            surface_kind=surf_kind,
            phase_kinds=tuple(kinds),
            polarized=m.is_polarized,
            max_depth=integrator.max_depth if integrator else 32,
            rr_depth=integrator.rr_depth if integrator else 5,
            ground_altitude=self.geometry.ground_altitude,
            toa_altitude=self.geometry.toa_altitude,
            has_surface=self.surface is not None,
            sampler=measure.sampler,
            illumination_kind=illumination_kind,
        )
        return scene, sensor, config
