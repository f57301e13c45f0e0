"""Experiment core.

Mirror of ``src/eradiate/experiments/_core.py``: an Experiment owns scene
elements + measures, compiles the scene, runs the engine and post-processes
results. Restructured hot path (SURVEY §3.4): instead of
the reference's serial {spectral ctx x sensor} Python loop around
``mi.render``, each measure's full spectral grid is compiled into a single
device-resident spectral batch and rendered in one (sharded) engine call.
"""

from __future__ import annotations

import logging

import attrs
import numpy as np

from ..core.modes import mode
from ..core.rng import SeedState, root_seed_state
from ..pipelines.logic import postprocess_measure
from ..scenes.core import SceneElement
from ..scenes.illumination import (
    DirectionalIllumination,
    Illumination,
    illumination_factory,
)
from ..scenes.integrators import Integrator, integrator_factory
from ..scenes.measure import Measure, measure_factory
from ..spectral.ckd_quad import CKDQuadConfig

logger = logging.getLogger(__name__)

__all__ = ["Experiment", "EarthObservationExperiment", "run"]


def _measures_converter(value):
    if isinstance(value, (Measure, dict)):
        value = [value]
    return [measure_factory.convert(m, Measure) for m in value]


def _illumination_converter(value):
    return illumination_factory.convert(value, Illumination)


def _integrator_converter(value):
    if value == "auto" or value is None:
        return None
    return integrator_factory.convert(value, Integrator)


def resolve_mesh(mesh):
    """Resolve the ``mesh`` argument of ``process()``/``run()``.

    - ``"auto"`` (default): a ("spectral", "sample") mesh over every
      visible device when more than one exists — distribution is the
      product path, not an opt-in (the reference has nothing to auto-mesh:
      its loops are serial Python, ``kernel/_render.py:433-468``). The
      ``ERADIATE_TPU_MESH=none`` setting forces single-device (used by the
      CPU test suite, which pins single-device reference outputs).
    - ``None``: single-device renderers.
    - a ``jax.sharding.Mesh`` with ("spectral", "sample") axes: used as-is.
    """
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(f"mesh must be 'auto', None or a Mesh, got {mesh!r}")
        from ..config import settings

        if str(settings.get("MESH", "auto")).lower() in ("none", "off", "0"):
            return None
        import jax

        n = len(jax.devices())
        if n <= 1:
            return None
        from ..parallel import make_render_mesh

        return make_render_mesh(1, n)
    return mesh


@attrs.define(eq=False, slots=False)
class Experiment(SceneElement):
    """Base experiment (``experiments/_core.py:129``)."""

    measures: list = attrs.field(
        factory=lambda: [measure_factory.convert({"type": "mdistant"})],
        converter=_measures_converter,
    )
    integrator: Integrator | None = attrs.field(
        default=None, converter=_integrator_converter
    )
    ckd_quad_config: CKDQuadConfig = attrs.field(
        factory=CKDQuadConfig, converter=CKDQuadConfig.convert
    )

    #: results per measure id, filled by postprocess()
    results: dict = attrs.field(factory=dict, init=False, repr=False)

    def clear(self):
        """Reset results (mirror of ``Experiment.clear``,
        ``_core.py:300-307``)."""
        self.results = {}
        for m in self.measures:
            m.results = {}

    # -- lifecycle ---------------------------------------------------------
    def init(self):
        raise NotImplementedError

    def process(self, spp=None, seed_state=None, checkpoint_dir=None,
                mesh="auto"):
        raise NotImplementedError

    def postprocess(self):
        raise NotImplementedError


@attrs.define(eq=False, slots=False)
class EarthObservationExperiment(Experiment):
    """Experiment with directional illumination
    (``experiments/_core.py:427``)."""

    illumination: Illumination = attrs.field(
        factory=DirectionalIllumination, converter=_illumination_converter
    )
    #: maximum spectral indices compiled into one device batch; larger
    #: grids (e.g. line-by-line mono DBs with ~3e5 wavelengths) stream in
    #: chunks — the replacement for the reference's serial
    #: spectral loop at bounded memory (SURVEY §7.3 "CKD spectral loop
    #: restructuring")
    spectral_chunk_size: int = attrs.field(default=4096, kw_only=True)

    # subclasses implement:
    def spectral_context(self, measure) -> dict:
        """Spectral evaluation arrays for one measure: dict with ``w`` [S]
        (+ CKD: ``g``, ``bin_index``, ``g_weights``, ``bin_wcenters``)."""
        raise NotImplementedError

    def compile_scene(self, measure, spectral_ctx):
        """Compile to (SceneArrays, SensorArrays, SceneConfig)."""
        raise NotImplementedError

    def init(self):
        pass

    def process(self, spp=None, seed_state=None, checkpoint_dir=None,
                mesh="auto"):
        import time

        from ..profiling import annotate, stats

        import numpy as _np

        mesh = resolve_mesh(mesh)
        checkpoint = None
        if checkpoint_dir is not None:
            from ..checkpoint import RenderCheckpoint

            checkpoint = RenderCheckpoint(checkpoint_dir)

        seed_state = seed_state or root_seed_state
        for measure in self.measures:
            ctx = self.spectral_context(measure)
            n = int(spp) if spp is not None else int(measure.spp)
            raws = []
            n_done = 0
            if checkpoint is not None:
                raws, n_done = checkpoint.load(measure.id, n, ctx["w"])
                import jax as _jax

                if _jax.process_count() > 1:
                    # hosts killed mid-loop may have persisted fewer
                    # chunks than survivors; resume from the MINIMUM so
                    # every process enters the sharded render for the
                    # same chunk (otherwise the collectives deadlock)
                    from jax.experimental import multihost_utils as _mhu

                    n_all = _np.asarray(
                        _mhu.process_allgather(_np.int64(n_done))
                    )
                    n_done = int(n_all.min())
                    raws = raws[:n_done]
            t0 = time.perf_counter()
            n_paths_pix = 0
            for ci, sub_ctx in enumerate(self._chunk_spectral_ctx(ctx)):
                # every chunk consumes its seed even when resumed-over, so
                # a resumed run reproduces the uninterrupted one exactly
                seed = int(seed_state.next())
                if ci < n_done:
                    continue
                scene, sensor, config = self.compile_scene(measure, sub_ctx)
                with annotate(f"render:{measure.id}"):
                    raw = self._render_one(
                        scene, sensor, config, n, seed, mesh=mesh
                    )
                # block so the recorded wall time covers device work
                raw = {
                    k: _np.asarray(v) if hasattr(v, "shape") else v
                    for k, v in raw.items()
                }
                n_paths_pix += int(
                    _np.asarray(sub_ctx["w"]).size * raw["radiance"].shape[1]
                )
                raws.append(raw)
                if checkpoint is not None:
                    checkpoint.save(measure.id, n, ctx["w"], raws)
            stats.record(
                label=f"measure:{measure.id}",
                wall_s=time.perf_counter() - t0,
                spectral_size=n_paths_pix,
                n_pixels=1,
                spp=n,
            )
            measure.results = {
                "raw": self._concat_raw(raws),
                "spectral_ctx": ctx,
            }

    def _chunk_spectral_ctx(self, ctx):
        import numpy as np

        S = int(np.asarray(ctx["w"]).size)
        step = max(int(self.spectral_chunk_size), 1)
        if S <= step:
            yield ctx
            return
        for start in range(0, S, step):
            sl = slice(start, min(start + step, S))
            sub = dict(ctx)
            for key in ("w", "g", "bin_index", "g_weights"):
                if key in ctx and ctx[key] is not None:
                    sub[key] = np.asarray(ctx[key])[sl]
            yield sub

    @staticmethod
    def _concat_raw(raws):
        import numpy as np

        if len(raws) == 1:
            return raws[0]
        out = {"spp": raws[0]["spp"]}
        for key in raws[0]:
            if key == "spp":
                continue
            out[key] = np.concatenate([np.asarray(r[key]) for r in raws], axis=0)
        return out

    def _render_one(self, scene, sensor, config, n, seed, mesh=None):
        if mesh is not None:
            from .. import parallel as par

            if config.geometry == "spherical_shell":
                fn = (
                    par.render_spherical_polarized_sharded
                    if config.polarized
                    else par.render_spherical_sharded
                )
                return fn(
                    scene.medium, scene.surface, scene.illumination, sensor,
                    config, spp=n, seed=seed, mesh=mesh,
                )
            fn = (
                par.render_polarized_sharded
                if config.polarized
                else par.render_sharded
            )
            return fn(scene, sensor, config, spp=n, seed=seed, mesh=mesh)

        from ..ops.tracer import render
        from ..ops.tracer_spherical import render_spherical

        if config.geometry == "spherical_shell":
            if config.polarized:
                from ..ops.tracer_spherical_polarized import (
                    render_spherical_polarized,
                )

                return render_spherical_polarized(
                    scene.medium,
                    scene.surface,
                    scene.illumination,
                    sensor,
                    config,
                    spp=n,
                    seed=seed,
                )
            return render_spherical(
                scene.medium,
                scene.surface,
                scene.illumination,
                sensor,
                config,
                spp=n,
                seed=seed,
            )
        if config.polarized:
            from ..ops.tracer_polarized import render_polarized

            return render_polarized(scene, sensor, config, spp=n, seed=seed)
        return render(scene, sensor, config, spp=n, seed=seed)

    def postprocess(self):
        for measure in self.measures:
            if not measure.results:
                continue
            mid = measure.id or f"measure_{self.measures.index(measure)}"
            self.results[mid] = postprocess_measure(
                measure,
                self.illumination,
                measure.results["raw"],
                measure.results["spectral_ctx"],
                mode(),
            )
        return self.results


def run(exp: Experiment, spp=None, seed_state=None, checkpoint_dir=None,
        mesh="auto"):
    """Run an experiment end-to-end (mirror of ``eradiate.run()``,
    ``experiments/_core.py:808-865``). Returns the result dataset of the
    first measure (the reference's convenience behavior) while filling
    ``exp.results`` for all measures.

    ``checkpoint_dir``: optional directory for spectral-chunk-granular
    accumulator checkpoints — an interrupted run re-invoked with the same
    configuration resumes after the last completed chunk (SURVEY §5).

    ``mesh``: ``"auto"`` (default) distributes over every visible device
    via a ("spectral", "sample") mesh; ``None`` forces single-device; an
    explicit ``jax.sharding.Mesh`` is used as-is. Sharded estimates equal
    single-device ones up to float summation order when ``spp`` divides by
    the sample-axis size (see :mod:`eradiate_tpu.parallel.render`).
    """
    exp.init()
    exp.process(spp=spp, seed_state=seed_state, checkpoint_dir=checkpoint_dir,
                mesh=mesh)
    exp.postprocess()
    if len(exp.results) == 1:
        return next(iter(exp.results.values()))
    return exp.results
