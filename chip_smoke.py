"""Run the path tracer end to end on an NVIDIA GPU and check its answers.

    python chip_smoke.py               # phases 0-2 on one card
    python chip_smoke.py --four-cards  # phase 0, then phase 3 only

Every render goes through the product entry points
(``AtmosphereExperiment`` / ``CanopyAtmosphereExperiment`` ->
``Experiment.process`` -> postprocess to BRF), in one process that holds
the card(s). Each phase prints its own lines; any failure raises, so the
script exits non-zero and prints no result line.

- Phase 0, environment: card name and power limit (``nvidia-smi``), JAX
  version, devices, compile-cache directory. Exits non-zero unless JAX's
  default backend is the GPU: there is no CPU fallback.
- Phase 1, c1 at full width: ``bench.py``'s headline scene (76 VZA
  principal plane, AFGL Rayleigh, Lambertian 0.5, SZA 30) at its bench spp
  (2^22), ``mono_single``, ``mesh=None``. Prints compile seconds, render
  seconds (best of 3) and samples/s. Every BRF must be finite and within
  ``N_SIGMA`` combined standard errors of the same scene rendered at spp
  2^14 by a CPU-only child process (``JAX_PLATFORMS=cpu``; it never opens
  the card).
- Phase 2, every tracer family: (a) each pinned self-regression case
  (plane-parallel, spherical, canopy, ocean) at its pin's spp and seed,
  through the same statistical test as
  ``tests/regression/test_self_regression.py``; (b) the polarized
  plane-parallel tracer against the deterministic doubling solver
  (``tests/system/test_doubling_anchor.py``); (c) the DEM marcher against
  the triangulated-mesh intersector (``tests/system/test_dem.py``); (d)
  ``bench.py``'s c2-c5 once each at their bench spp: finite BRFs, samples/s
  and compile seconds (JAX's trace, lowering and XLA-compile spans inside
  the call; the render time is the call's wall time minus them).
- Phase 3 (``--four-cards``): c1 with ``mesh="auto"`` over four cards
  against ``mesh=None`` on card 0, same seed. Sample ids partition exactly
  across the sample axis, so only f32 summation order may differ: the BRFs
  must agree within ``SHARDED_RTOL``.

The last stdout line is one JSON object: ``{"ok": true, "device":
{"platform": ..., "kind": ..., "count": ...}}`` as JAX reports the devices.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

#: Phase 1: per-pixel agreement with the CPU render in combined standard
#: errors. Both sides are unbiased MC estimates of the same BRF; at 4 sigma
#: a correct engine fails one of the 76 pixels with probability ~0.5%.
N_SIGMA = 4.0
#: Phase 1: spp of the CPU reference render.
CPU_REF_SPP = 2**14
#: Phase 3: sharded vs single-card BRF. Sample ids partition exactly, so
#: the estimates differ only by the f32 summation order of the per-lane
#: and per-shard partial sums.
SHARDED_RTOL = 1e-4
#: Seed of every timed or compared c1 render.
SEED = 1


class SmokeFailure(RuntimeError):
    """A phase produced a wrong or non-finite answer."""


def _check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def _load_test_module(relpath):
    """Import one of the repo's test files by path, so that a phase runs
    the test's own check at the test's own tolerance."""
    path = os.path.join(HERE, relpath)
    name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return out.replace("\n", " | ")


def _radiance_and_sigma(exp):
    """(radiance [N], standard error [N]) of a one-row, one-measure
    experiment; the standard error comes from the in-render second-moment
    accumulator, as in ``bench.py`` (independent sampler)."""
    raw = exp.measures[0].results["raw"]
    rad = np.asarray(raw["radiance"], dtype=np.float64).ravel()
    m2 = np.asarray(raw["m2"], dtype=np.float64).ravel()
    return rad, np.sqrt(np.maximum(m2 - rad * rad, 0.0) / raw["spp"])


def _brf(exp):
    """Postprocessed BRF values of every measure, flattened."""
    exp.postprocess()
    return np.concatenate([
        np.asarray(res["brf"].values, dtype=np.float64).ravel()
        for res in exp.results.values()
    ])


def _n_samples(exp):
    n = 0
    for m in exp.measures:
        raw = m.results["raw"]
        n += raw["radiance"].shape[0] * raw["radiance"].shape[1] * raw["spp"]
    return n


#: JAX's own compile-phase events: tracing, lowering to MLIR, and the XLA
#: compile (or its load from the persistent cache).
_COMPILE_EVENTS = (
    "/jax/core/compile/jaxpr_trace_duration",
    "/jax/core/compile/jaxpr_to_mlir_module_duration",
    "/jax/core/compile/backend_compile_duration",
)


def _timed_process(exp, spp, seed, mesh):
    """(wall s, compile s) of one ``exp.process``; compile s is the union
    of JAX's compile-phase spans (nested traces overlap) inside the call."""
    import jax
    from eradiate_tpu.core.rng import SeedState

    spans = []

    def on_span(event, start, end, **_):
        if event in _COMPILE_EVENTS:
            spans.append((start, end))

    jax.monitoring.register_event_time_span_listener(on_span)
    try:
        t0 = time.perf_counter()
        exp.process(spp=spp, seed_state=SeedState(seed), mesh=mesh)
        # canopy and DEM experiments keep device arrays in their results
        jax.block_until_ready([m.results["raw"] for m in exp.measures])
        wall = time.perf_counter() - t0
    finally:
        jax.monitoring.unregister_event_time_span_listener(on_span)
    compile_s, end = 0.0, float("-inf")
    for start, stop in sorted(spans):
        compile_s += max(stop - max(start, end), 0.0)
        end = max(end, stop)
    return wall, compile_s


def _c1():
    import bench
    import eradiate_tpu as ert

    ert.set_mode("mono_single")
    exp = bench._c1()
    exp.init()
    return exp


def cpu_reference():
    """Child mode: c1 at CPU_REF_SPP on the CPU; prints one JSON line."""
    import jax

    _check(jax.default_backend() == "cpu", "CPU reference must run on the CPU")
    exp = _c1()
    _timed_process(exp, CPU_REF_SPP, SEED + 100, None)
    rad, sigma = _radiance_and_sigma(exp)
    print(json.dumps({"radiance": rad.tolist(), "sigma": sigma.tolist()}))


def _start_cpu_reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-reference"],
        cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
    )


def phase0(four):
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"phase 0: FAIL default backend is {backend!r}, not 'gpu'",
              file=sys.stderr)
        sys.exit(2)
    import eradiate_tpu  # noqa: F401  (applies the compile-cache setting)

    devices = jax.devices()
    card = _card_line()
    print(f"phase 0: card {card}")
    print(f"phase 0: jax {jax.__version__} devices {devices}")
    print(f"phase 0: compile cache {jax.config.jax_compilation_cache_dir}")
    if four:
        _check(len(devices) == 4, f"--four-cards: JAX sees {len(devices)}")
    return devices, card


def phase1(card):
    import bench

    ref_proc = _start_cpu_reference()
    try:
        spp = bench.SPP_C1
        exp = _c1()
        _, compile_s = _timed_process(exp, spp, SEED, None)
        best = min(_timed_process(exp, spp, SEED, None)[0] for _ in range(3))
        n = _n_samples(exp)
        rad, sigma = _radiance_and_sigma(exp)
        brf = _brf(exp)
        print(
            f"phase 1: c1 {rad.size} VZA x spp {spp}:"
            f" compile {compile_s:.1f} s,"
            f" render {best:.3f} s (best of 3), {n / best:.4g} samples/s"
            f" [{card}]"
        )
        _check(np.all(np.isfinite(brf)), "phase 1: non-finite BRF")
        out, err = ref_proc.communicate(timeout=900)
        _check(ref_proc.returncode == 0,
               f"phase 1: CPU reference failed:\n{err[-4000:]}")
        ref = json.loads(out.strip().splitlines()[-1])
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
            ref_proc.wait()
    comb = np.sqrt(sigma**2 + np.asarray(ref["sigma"]) ** 2)
    z = np.abs(rad - np.asarray(ref["radiance"])) / np.maximum(comb, 1e-30)
    print(
        f"phase 1: vs CPU spp {CPU_REF_SPP}: max |d|/sigma {z.max():.2f}"
        f" (limit {N_SIGMA}), BRF range [{brf.min():.4f}, {brf.max():.4f}]"
    )
    _check(np.all(z <= N_SIGMA), f"phase 1: pixels beyond {N_SIGMA} sigma: "
           f"{np.flatnonzero(z > N_SIGMA).tolist()}")


def phase2():
    import eradiate_tpu as ert

    # (a) pinned self-regression cases: the test's own statistical check
    reg = _load_test_module("tests/regression/test_self_regression.py")
    for case_id in sorted(reg.CASES):
        ert.set_mode("mono")
        t0 = time.perf_counter()
        reg.test_matches_pinned_reference(case_id, None)
        print(f"phase 2a: {case_id} matches its pin"
              f" ({time.perf_counter() - t0:.1f} s)")

    # (b) polarized plane-parallel tracer vs the doubling solver
    dbl = _load_test_module("tests/system/test_doubling_anchor.py")
    anchor = dbl.TestPolarizedTracerVsDoubling()
    for reflectance, depol in ((0.0, 0.0), (0.3, 0.0), (0.3, 0.0279)):
        ert.set_mode("mono")
        t0 = time.perf_counter()
        anchor.test_stokes_match(reflectance, depol)
        print(f"phase 2b: doubling anchor reflectance {reflectance} depol"
              f" {depol} ok ({time.perf_counter() - t0:.1f} s)")

    # (c) DEM: SDF marcher vs the exact triangulated mesh
    dem = _load_test_module("tests/system/test_dem.py")
    ert.set_mode("mono")
    t0 = time.perf_counter()
    dem.test_marcher_cross_gates_triangulated_mesh(None)
    print(f"phase 2c: DEM marcher vs triangulated mesh ok"
          f" ({time.perf_counter() - t0:.1f} s)")

    # (d) bench.py's c2-c5 at their bench spp
    import bench

    for key, make_exp, spp, mode in bench.CONFIGS[1:]:
        ert.set_mode(mode)
        exp = make_exp()
        exp.init()
        wall, compile_s = _timed_process(exp, spp, 0, None)
        render_s = wall - compile_s
        print(
            f"phase 2d: {key} spp {spp}: compile {compile_s:.1f} s,"
            f" render {render_s:.3f} s (one call, wall minus compile),"
            f" {_n_samples(exp) / render_s:.4g} samples/s"
        )
        _check(np.all(np.isfinite(_brf(exp))), f"phase 2d: {key} non-finite")


def phase3(card):
    import bench

    spp = bench.SPP_C1
    exp = _c1()
    _, compile4 = _timed_process(exp, spp, SEED, "auto")
    wall4, _ = _timed_process(exp, spp, SEED, "auto")
    brf4 = _brf(exp)
    _timed_process(exp, spp, SEED, None)
    wall1, _ = _timed_process(exp, spp, SEED, None)
    brf1 = _brf(exp)
    n = _n_samples(exp)
    rel = np.abs(brf4 - brf1) / np.maximum(np.abs(brf1), 1e-30)
    print(
        f"phase 3: c1 spp {spp}: 4 cards {n / wall4:.4g} samples/s"
        f" ({wall4:.3f} s, compile {compile4:.1f} s), 1 card"
        f" {n / wall1:.4g} samples/s ({wall1:.3f} s),"
        f" max rel dBRF {rel.max():.3g} (limit {SHARDED_RTOL}) [{card}]"
    )
    _check(np.all(np.isfinite(brf4)), "phase 3: non-finite sharded BRF")
    _check(np.all(rel <= SHARDED_RTOL), "phase 3: sharded BRF differs")


def main(argv):
    if argv == ["--cpu-reference"]:
        cpu_reference()
        return
    four = argv == ["--four-cards"]
    if argv and not four:
        raise SystemExit(f"usage: {sys.argv[0]} [--four-cards]")
    sys.path.insert(0, HERE)
    # resolve_mesh("auto") honours ERADIATE_TPU_MESH; phase 3 needs "auto"
    os.environ.pop("ERADIATE_TPU_MESH", None)
    devices, card = phase0(four)
    if four:
        phase3(card)
    else:
        phase1(card)
        phase2()
    dev = devices[0]
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(devices),
        },
    }))


if __name__ == "__main__":
    main(sys.argv[1:])
