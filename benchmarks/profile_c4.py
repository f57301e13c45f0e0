"""Profiler op-profile of the c4 spherical config (post-shell-merge).

Run from the repo root: python benchmarks/profile_c4.py
"""

import glob
import json
import os
import sys
import time

import numpy as np

import jax

import eradiate_tpu as ert
from eradiate_tpu.core.rng import SeedState
from eradiate_tpu.experiments import AtmosphereExperiment
from eradiate_tpu.scenes.geometry import EARTH_RADIUS_KM

TOL = float(sys.argv[1]) if len(sys.argv) > 1 else 1e-3
SPP = 131072


def make(tol):
    return AtmosphereExperiment(
        geometry={"type": "spherical_shell", "shell_merge_tol": tol},
        illumination={"type": "directional", "zenith": 75.0, "azimuth": 0.0},
        measures={
            "type": "mdistant",
            "construct": "hplane",
            "zeniths": np.arange(-85.0, 65.0, 10.0),
            "azimuth": 0.0,
            "target": [0.0, 0.0, EARTH_RADIUS_KM],
            "id": "m",
        },
        surface={"type": "hapke"},
        atmosphere={"type": "molecular"},
    )


def main():
    ert.set_mode("mono_single")
    exp = make(TOL)
    exp.init()
    exp.process(spp=SPP, seed_state=SeedState(0), mesh=None)  # warm
    t0 = time.perf_counter()
    exp.process(spp=SPP, seed_state=SeedState(1), mesh=None)
    dt = time.perf_counter() - t0
    n = 15 * SPP
    print(f"rate {n/dt/1e6:.2f} M samples/s ({dt:.3f} s)", flush=True)

    logdir = "/tmp/xprof_c4"
    os.system(f"rm -rf {logdir}")
    with jax.profiler.trace(logdir):
        exp.process(spp=SPP, seed_state=SeedState(2), mesh=None)

    from xprof.convert.raw_to_tool_data import xspace_to_tool_data

    files = glob.glob(f"{logdir}/**/*.xplane.pb", recursive=True)
    data, _ = xspace_to_tool_data(files, "op_profile", {})
    prof = json.loads(data)

    def walk(node, depth=0, path=""):
        m = node.get("metrics", {})
        t = m.get("timeFraction", 0)
        name = node.get("name", "?")
        if t and t > 0.01 and depth <= 3:
            print(f"{'  '*depth}{t*100:5.1f}%  {name[:110]}")
        for ch in node.get("children", []):
            walk(ch, depth + 1, path + "/" + name)

    root = prof.get("byProgram") or prof.get("byCategory") or prof
    walk(root)


if __name__ == "__main__":
    main()
