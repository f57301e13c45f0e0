"""Profiling & performance counters.

SURVEY §5 flags the reference's tracing story as minimal (tqdm progress
gated by ``ProgressLevel``, ``config/_settings.py:14-61``) and directs this
build to make ``jax.profiler`` traces and per-kernel samples/s counters
first-class. This module provides:

- :func:`trace` — context manager around ``jax.profiler.trace`` writing a
  TensorBoard/XProf trace directory;
- :func:`annotate` — named ``TraceAnnotation`` scope so driver phases show
  up on the trace timeline;
- :class:`RenderStats` + the global :data:`stats` recorder — wall-clock,
  path counts and samples/s for every render dispatch, queryable after a
  run (``eradiate_tpu.profiling.stats.last`` / ``.summary()``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

__all__ = [
    "trace",
    "annotate",
    "RenderStats",
    "stats",
    "timed_render",
    "DEVICE_PEAKS",
    "device_peaks",
    "kernel_roofline",
]


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """Capture a device+host profiler trace into ``log_dir`` (view with
    TensorBoard's profile plugin or Perfetto)."""
    import jax

    with jax.profiler.trace(str(log_dir), create_perfetto_link=create_perfetto_link):
        yield


@contextlib.contextmanager
def annotate(name: str):
    """Named scope visible on profiler timelines (host + device)."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield


@dataclasses.dataclass
class RenderRecord:
    label: str
    wall_s: float
    n_paths: int
    spectral_size: int
    n_pixels: int
    spp: int

    @property
    def samples_per_s(self) -> float:
        return self.n_paths / self.wall_s if self.wall_s > 0 else 0.0


class RenderStats:
    """Accumulates per-dispatch render statistics."""

    def __init__(self):
        self.records: list[RenderRecord] = []

    def record(self, label, wall_s, spectral_size, n_pixels, spp):
        rec = RenderRecord(
            label=label,
            wall_s=wall_s,
            n_paths=int(spectral_size) * int(n_pixels) * int(spp),
            spectral_size=int(spectral_size),
            n_pixels=int(n_pixels),
            spp=int(spp),
        )
        self.records.append(rec)
        return rec

    @property
    def last(self) -> RenderRecord | None:
        return self.records[-1] if self.records else None

    def summary(self) -> dict:
        """Aggregate counters: total paths, wall time, mean samples/s."""
        if not self.records:
            return {"n_renders": 0, "total_paths": 0, "total_wall_s": 0.0,
                    "samples_per_s": 0.0}
        total_paths = sum(r.n_paths for r in self.records)
        total_wall = sum(r.wall_s for r in self.records)
        return {
            "n_renders": len(self.records),
            "total_paths": total_paths,
            "total_wall_s": total_wall,
            "samples_per_s": total_paths / total_wall if total_wall > 0 else 0.0,
        }

    def clear(self):
        self.records.clear()


#: global recorder fed by the experiment drivers
stats = RenderStats()


def timed_render(label, fn, *, spectral_size, n_pixels, spp):
    """Run ``fn()`` (a render returning device arrays), block on the
    result, and record wall time + samples/s under ``label``."""
    import jax

    t0 = time.perf_counter()
    out = fn()
    out = jax.block_until_ready(out)
    wall = time.perf_counter() - t0
    stats.record(label, wall, spectral_size, n_pixels, spp)
    return out


# ---------------------------------------------------------------------------
# Roofline accounting (BASELINE: kernels "profiled to speed-of-light")

#: Published per-device peaks, keyed by ``jax.Device.device_kind``. Source:
#: NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
#: 700 W power limit (a card set below it cannot hold these clocks under
#: load, so report its ``power.limit`` beside any fraction of these).
#: ``fp32`` is the rate outside the tensor cores. A device that is not
#: listed has no assumed peak.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "bf16_flop_per_s": 989e12,
        "fp32_flop_per_s": 67e12,
    },
}


def device_peaks(device_kind: str | None = None) -> dict:
    """Peaks of ``device_kind`` (default: the first JAX device's kind).
    Raises ``ValueError`` for a device kind that is not in
    :data:`DEVICE_PEAKS`."""
    if device_kind is None:
        import jax

        device_kind = jax.devices()[0].device_kind
    try:
        return DEVICE_PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; "
            "add its data-sheet rates to profiling.DEVICE_PEAKS"
        ) from None


def kernel_roofline(
    label, wall_s, flops, bytes_moved, unit="fp32", device_kind=None
):
    """Achieved-vs-peak accounting for one kernel invocation.

    ``flops``: analytic FLOP count of the invocation; ``bytes_moved``:
    analytic device-memory traffic (reads + writes); ``unit``: which
    compute ceiling applies ("bf16" for tensor-core matmuls, "fp32" for
    elementwise f32 work); ``device_kind``: whose peaks (default: the
    first JAX device). Returns a dict with achieved rates, fractions of
    peak, arithmetic intensity, and the bound resource (whichever fraction
    is higher — that resource sets the kernel's speed-of-light).
    """
    peaks = device_peaks(device_kind)
    peak_flops = peaks[f"{unit}_flop_per_s"]
    peak_bw = peaks["hbm_bytes_per_s"]
    achieved_flops = flops / wall_s if wall_s > 0 else 0.0
    achieved_bw = bytes_moved / wall_s if wall_s > 0 else 0.0
    frac_compute = achieved_flops / peak_flops
    frac_bw = achieved_bw / peak_bw
    return {
        "label": label,
        "wall_s": wall_s,
        "gflop_per_s": achieved_flops / 1e9,
        "gbytes_per_s": achieved_bw / 1e9,
        "frac_compute_peak": frac_compute,
        "frac_hbm_peak": frac_bw,
        "intensity_flop_per_byte": (
            flops / bytes_moved if bytes_moved else float("inf")
        ),
        "ridge_flop_per_byte": peak_flops / peak_bw,
        "bound": "compute" if frac_compute >= frac_bw else "hbm",
        "speed_of_light_frac": max(frac_compute, frac_bw),
    }
