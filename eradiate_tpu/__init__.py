"""eradiate_tpu — radiative transfer for Earth observation in JAX.

A from-scratch JAX/XLA re-implementation of the capabilities of
Eradiate (Monte Carlo radiative transfer for Earth observation): where the
reference drives a C++ Mitsuba kernel through a serial spectral loop
(``src/eradiate/kernel/_render.py:433-468``), this framework runs a
device-resident wavefront path tracer batched over
{spectral index x pixel x sample}, sharded across device meshes.

Public surface mirrors the reference's: ``set_mode``/``mode``, ``run``,
experiment classes, scene-element factories, units.
"""

from .core.modes import Mode, ModeFlag, mode, modes, set_mode  # noqa: F401
from .core.units import ureg  # noqa: F401
from .core.rng import SeedState, root_seed_state  # noqa: F401
from .config import apply_settings as _apply_settings

__version__ = "0.1.0"

# resolve ERADIATE_TPU_* settings into the runtime (root seed, data search
# paths, persistent compilation cache)
_apply_settings()


def run(exp, spp=None, seed_state=None, checkpoint_dir=None, mesh="auto"):
    """Run an experiment end-to-end and return its results.

    Mirror of ``eradiate.run()`` (``src/eradiate/experiments/_core.py:808``),
    plus the distribution the reference lacks: ``mesh="auto"`` shards the
    render over every visible device (see
    :func:`eradiate_tpu.experiments.run`).
    """
    from .experiments import run as _run

    return _run(
        exp, spp=spp, seed_state=seed_state, checkpoint_dir=checkpoint_dir,
        mesh=mesh,
    )


def __getattr__(name):
    # Lazy subpackage access (mirrors the reference's lazy_loader surface).
    import importlib

    if name in {
        "core",
        "physics",
        "spectral",
        "scenes",
        "ops",
        "parallel",
        "pipelines",
        "experiments",
        "data",
        "xr",
        "units",
        "sensitivity",
    }:
        if name == "units":
            from .core import units as mod
            return mod
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module 'eradiate_tpu' has no attribute '{name}'")
