"""Settings system.

Mirror of ``src/eradiate/config/_settings.py:146-198`` (Dynaconf-based in
the reference; dependency-free here): values resolve, in priority order,
from (1) ``ERADIATE_TPU_*`` environment variables, (2) an
``eradiate.toml`` file in the working directory or ``$HOME``, (3) defaults.

Supported keys (mirroring the reference's):
- ``DATA_PATH``: extra data-store search paths (os.pathsep-separated)
- ``OFFLINE``: bool (informational; this build has no downloader)
- ``PROGRESS``: ``NONE`` | ``SPECTRAL_LOOP`` | ``KERNEL``
- ``RNG_SEED``: int root seed for :data:`eradiate_tpu.root_seed_state`
- ``AZIMUTH_CONVENTION``: default azimuth convention name
- ``ABSORPTION_DATABASE_ERROR_HANDLING``: 'raise' | 'clamp' | 'zero'
"""

from __future__ import annotations

import enum
import logging
import os
from pathlib import Path

__all__ = ["settings", "ProgressLevel"]


class ProgressLevel(enum.IntEnum):
    """Mirror of ``config/_settings.py:14-61``."""

    NONE = 0
    SPECTRAL_LOOP = 1
    KERNEL = 2


_DEFAULTS = {
    "DATA_PATH": "",
    "OFFLINE": True,
    "PROGRESS": "SPECTRAL_LOOP",
    "RNG_SEED": 0,
    "AZIMUTH_CONVENTION": "EAST_RIGHT",
    "ABSORPTION_DATABASE_ERROR_HANDLING": "clamp",
}

_ENV_PREFIX = "ERADIATE_TPU_"


def _load_file_settings() -> dict:
    import tomllib

    for base in (Path.cwd(), Path.home()):
        path = base / "eradiate.toml"
        if path.exists():
            try:
                with open(path, "rb") as f:
                    data = tomllib.load(f)
                return {k.upper(): v for k, v in data.items()}
            except Exception:
                return {}
    return {}


class Settings:
    def __init__(self):
        self._file = None

    def _file_settings(self):
        if self._file is None:
            self._file = _load_file_settings()
        return self._file

    def get(self, key: str, default=None):
        key = key.upper().replace(".", "_")
        env = os.environ.get(_ENV_PREFIX + key)
        if env is not None:
            return self._coerce(key, env)
        if key in self._file_settings():
            return self._file_settings()[key]
        if key in _DEFAULTS:
            return _DEFAULTS[key]
        return default

    def _coerce(self, key, value):
        ref = _DEFAULTS.get(key)
        if isinstance(ref, bool):
            return value.lower() in ("1", "true", "yes", "on")
        if isinstance(ref, int):
            return int(value)
        return value

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return self.get(name)

    @property
    def progress(self) -> ProgressLevel:
        return ProgressLevel[str(self.get("PROGRESS", "SPECTRAL_LOOP")).upper()]

    def reload(self):
        self._file = None


#: Global settings object (mirror of ``eradiate.config.settings``)
settings = Settings()


def apply_settings():
    """Apply settings to the runtime (seed, data path, compile cache)."""
    from .core.rng import root_seed_state
    from .data import register_data_path

    seed = settings.get("RNG_SEED")
    if seed:
        root_seed_state.reset(int(seed))
    for p in str(settings.get("DATA_PATH", "")).split(os.pathsep):
        if p:
            register_data_path(p)
    _enable_compilation_cache()


def _host_fingerprint() -> str:
    """Short stable id for the host microarchitecture: hash of the CPU
    flags (the feature set XLA:CPU AOT-compiles against) + machine type.
    Hosts with identical flags share cache entries; any difference —
    e.g. a VM generation change between driver rounds — lands in a
    separate directory instead of loading foreign machine code."""
    import hashlib
    import platform

    ident = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    ident += " " + " ".join(sorted(line.split()[2:]))
                    break
    except OSError:
        ident += " " + platform.processor()
    return hashlib.sha256(ident.encode()).hexdigest()[:12]


#: Default persistent-cache root when ``JAX_COMPILATION_CACHE_DIR`` is
#: unset: a fixed directory in the checkout (listed in ``.gitignore``), so
#: every process started from the same checkout finds the same entries.
DEFAULT_CACHE_ROOT = Path(__file__).resolve().parent.parent / ".jax_cache"


def compilation_cache_dir() -> str:
    """The persistent compile-cache directory this process uses: the
    user's ``JAX_COMPILATION_CACHE_DIR`` as is, else
    ``<checkout>/.jax_cache/<host fingerprint>``.

    The default is segmented by a host-CPU fingerprint: XLA:CPU cache
    entries embed AOT machine code compiled for the features the compiling
    host detected, and loading them on a host with a different CPU is
    undefined behaviour (observed as segfaults inside
    ``backend_compile_and_load`` after a different VM generation shared a
    cache directory). JAX's cache key does not cover the host
    microarchitecture, so the directory name must.
    """
    import jax

    user = jax.config.jax_compilation_cache_dir
    if user:
        return user
    return str(DEFAULT_CACHE_ROOT / _host_fingerprint())


def _enable_compilation_cache():
    """Point JAX's persistent compilation cache at
    :func:`compilation_cache_dir`.

    The wavefront tracer programs take O(minutes) to compile the first
    time (XLA while-loop + nested vmaps); caching makes every later
    process start at dispatch speed. A user-set ``JAX_COMPILATION_CACHE_DIR``
    is used as is and no other directory is set. Opt out with
    ``ERADIATE_TPU_COMPILATION_CACHE=0``.
    """
    flag = str(settings.get("COMPILATION_CACHE", "1")).lower()
    if flag in ("0", "false", "no", "off"):
        return
    try:
        import jax

        if not jax.config.jax_compilation_cache_dir:
            cache_dir = compilation_cache_dir()
            os.makedirs(cache_dir, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", cache_dir)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
        # cache every sizable program, even with slight env differences
        jax.config.update(
            "jax_persistent_cache_min_entry_size_bytes", 0
        )
    except Exception:  # pragma: no cover - cache is best-effort
        logging.getLogger(__name__).debug(
            "could not enable the JAX compilation cache", exc_info=True
        )
