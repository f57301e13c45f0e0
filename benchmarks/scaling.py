"""Scaling-efficiency harness: samples/s at 1 device vs N devices.

BASELINE demands >=90% scaling efficiency to 2 hosts. The reference has
nothing to scale (serial Python loops around a single-host C++ kernel,
``src/eradiate/kernel/_render.py:433-468``); this harness measures this
build's sample-axis scaling on whatever devices exist:

- on a multi-GPU host: real cards over NVLink (run under
  ``eradiate_tpu.parallel.initialize()`` for multi-host);
- on CPU: N virtual devices (mechanism check, not a perf claim — virtual
  CPU devices share the same cores, so efficiency there measures collective
  overhead only at fixed total compute).

Usage::

    python benchmarks/scaling.py [--devices 8] [--spp 262144] [--pixels 64]

Prints one JSON line per device count:
    {"n_devices": N, "samples_per_s": R, "efficiency": R / (N * R1)}
and a final summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def build_scene(S, n_layers, n_pix):
    import jax.numpy as jnp
    import numpy as np

    from eradiate_tpu.core.frame import angles_to_direction
    from eradiate_tpu.ops.medium import cumulative_tau
    from eradiate_tpu.ops.scene_state import (
        IlluminationArrays,
        MediumArrays,
        SceneArrays,
        SceneConfig,
        SensorArrays,
        SurfaceArrays,
    )

    z_levels = jnp.linspace(0.0, 100.0, n_layers + 1)
    # Rayleigh-like exponential profile
    sigma = 0.012 * np.exp(-np.linspace(0, 100, n_layers) / 8.5)
    sigma_t = jnp.broadcast_to(jnp.asarray(sigma, jnp.float32), (S, n_layers))
    med = MediumArrays(
        z_levels=z_levels,
        tau_levels=cumulative_tau(sigma_t, z_levels),
        albedo=jnp.full((S, n_layers), 0.99),
        phase_weights=jnp.ones((S, 1, n_layers)),
        phase_params=({"depol": jnp.zeros((S, n_layers))},),
    )
    surf = SurfaceArrays(params={"reflectance": jnp.full(S, 0.5)})
    d_sun = -angles_to_direction([np.deg2rad(30.0), 0.0])[0]
    illum = IlluminationArrays(
        direction=jnp.asarray(d_sun),
        irradiance=jnp.ones(S),
        cos_cutoff=1.0,
        sky_radiance=jnp.zeros(S),
    )
    scene = SceneArrays(medium=med, surface=surf, illumination=illum)
    vzas = np.linspace(-75, 75, n_pix)
    dirs = angles_to_direction(
        np.stack([np.deg2rad(vzas), np.zeros(n_pix)], axis=-1)
    )
    sensor = SensorArrays(
        directions=jnp.asarray(dirs), target=jnp.zeros(3), ray_offset=jnp.nan
    )
    return scene, sensor, SceneConfig()


def measure(scene, sensor, config, spp, mesh, repeats=3):
    """Best-of-N samples/s for one mesh (None = single-device render)."""
    import jax
    import numpy as np

    from eradiate_tpu.ops.tracer import render
    from eradiate_tpu.parallel import render_sharded

    def once():
        if mesh is None:
            out = render(scene, sensor, config, spp=spp, seed=0)
        else:
            out = render_sharded(
                scene, sensor, config, spp=spp, seed=0, mesh=mesh
            )
        jax.block_until_ready(out["radiance"])
        return out

    once()  # compile
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = once()
        best = min(best, time.perf_counter() - t0)
    n_pix = np.asarray(sensor.directions).shape[0]
    S = np.asarray(scene.medium.tau_levels).shape[0]
    return S * n_pix * out["spp"] / best


_TWO_HOST_WORKER = """
import json, sys, time
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", {local_devices})
jax.distributed.initialize(
    coordinator_address="localhost:{port}",
    num_processes={n_procs},
    process_id={pid},
)
import os, sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, {here!r})
from scaling import build_scene, measure
from eradiate_tpu.parallel import make_render_mesh

scene, sensor, config = build_scene({spectral}, {layers}, {pixels})
mesh = make_render_mesh(1, {total_devices})
rate = measure(scene, sensor, config, {spp}, mesh)
if {pid} == 0:
    print("RATE", rate)
"""


def run_two_host(args):
    """1 vs 2 OS processes over localhost TCP (the inter-host stand-in), CPU
    backend, FIXED total work and fixed total device count (8 virtual
    devices either way — virtual CPU devices share the same physical
    cores, so doubling them cannot double compute; what this measures is
    the multi-process overhead: TCP collectives, cross-process dispatch,
    gRPC coordination).  Efficiency = rate(2 procs) / rate(1 proc);
    BASELINE's >=90% target maps to this ratio staying >=0.9 at fixed
    compute.  The same harness runs unchanged on two real hosts, where the
    device count genuinely doubles."""
    import subprocess
    import sys as _sys

    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(here)
    rates = {}
    for n_procs in (1, 2):
        local = 8 // n_procs
        port = 12397 + n_procs
        procs = []
        for pid in range(n_procs):
            code = _TWO_HOST_WORKER.format(
                local_devices=local, port=port, n_procs=n_procs, pid=pid,
                repo=repo, here=here, spectral=args.spectral,
                layers=args.layers, pixels=args.pixels, spp=args.spp,
                total_devices=8,
            )
            procs.append(subprocess.Popen(
                [_sys.executable, "-c", code],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            ))
        outs = [pr.communicate(timeout=1200) for pr in procs]
        for pr, (out, err) in zip(procs, outs):
            if pr.returncode != 0:
                print(err[-2000:], file=_sys.stderr)
                raise SystemExit(f"{n_procs}-process worker failed")
        for out, _ in outs:
            for line in out.splitlines():
                if line.startswith("RATE"):
                    rates[n_procs] = float(line.split()[1])
    eff = rates[2] / rates[1]
    print(json.dumps({
        "metric": "two_host_efficiency_fixed_work",
        "backend": "cpu",
        "samples_per_s_1proc_8dev": rates[1],
        "samples_per_s_2proc_4dev_each": rates[2],
        "efficiency": eff,
    }))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=None,
                    help="max devices (default: all; CPU default 8 virtual)")
    ap.add_argument("--spp", type=int, default=262144)
    ap.add_argument("--pixels", type=int, default=64)
    ap.add_argument("--layers", type=int, default=128)
    ap.add_argument("--spectral", type=int, default=1)
    ap.add_argument(
        "--cpu", action="store_true",
        help="force N virtual CPU devices (mechanism check; set through "
        "the jax config API, which wins over the JAX_PLATFORMS env var)",
    )
    ap.add_argument(
        "--two-host", action="store_true",
        help="measure 1 vs 2 OS processes over localhost TCP at fixed "
        "total work and device count (see run_two_host)",
    )
    args = ap.parse_args()

    if args.two_host:
        run_two_host(args)
        return

    import jax

    if args.cpu:
        try:
            jax.config.update("jax_platforms", "cpu")
            jax.config.update("jax_num_cpu_devices", args.devices or 8)
        except RuntimeError:
            pass
    elif args.devices and jax.default_backend() == "cpu":
        try:
            jax.config.update("jax_num_cpu_devices", args.devices)
        except RuntimeError:
            pass

    from eradiate_tpu.parallel import initialize, make_render_mesh

    initialize()
    devices = jax.devices()
    n_max = min(args.devices or len(devices), len(devices))

    scene, sensor, config = build_scene(args.spectral, args.layers, args.pixels)

    rows = []
    r1 = None
    n = 1
    while n <= n_max:
        mesh = (
            None if n == 1
            else make_render_mesh(1, n, devices=devices[:n])
        )
        rate = measure(scene, sensor, config, args.spp, mesh)
        if r1 is None:
            r1 = rate
        row = {
            "n_devices": n,
            "samples_per_s": rate,
            "efficiency": rate / (n * r1),
        }
        rows.append(row)
        print(json.dumps(row))
        n *= 2

    print(json.dumps({
        "metric": "scaling_efficiency",
        "backend": jax.default_backend(),
        "n_hosts": jax.process_count(),
        "max_devices": rows[-1]["n_devices"],
        "efficiency_at_max": rows[-1]["efficiency"],
    }))


if __name__ == "__main__":
    main()
