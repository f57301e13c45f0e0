"""Measure c4 (spherical Hapke SZA75) rate and BRF error vs shell merge tol.

Run from the repo root: python benchmarks/sweep_shell_merge.py
One process, sequential configs (one process per card).
"""

import json
import time

import numpy as np

import eradiate_tpu as ert
from eradiate_tpu.core.rng import SeedState
from eradiate_tpu.experiments import AtmosphereExperiment
from eradiate_tpu.scenes.geometry import EARTH_RADIUS_KM

SPP = 131072
SPP_ACC = 524288  # accuracy comparison spp


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


def rate_and_brf(tol, spp, reps=3):
    ert.set_mode("mono_single")
    exp = make(tol)
    exp.init()
    exp.process(spp=spp, seed_state=SeedState(0), mesh=None)  # warm/compile
    m = exp.measures[0]
    raw = m.results["raw"]
    samples = raw["radiance"].shape[0] * raw["radiance"].shape[1] * raw["spp"]
    best = float("inf")
    for i in range(reps):
        t0 = time.perf_counter()
        exp.process(spp=spp, seed_state=SeedState(1), mesh=None)
        best = min(best, time.perf_counter() - t0)
    raw = exp.measures[0].results["raw"]
    rad = np.asarray(raw["radiance"])[0]
    m2 = np.asarray(raw["m2"])[0]
    var_mean = np.maximum(m2 - rad * rad, 0.0) / raw["spp"]
    L = np.asarray(raw.get("n_layers", 0))
    return samples / best, rad, var_mean


def main():
    out = {}
    # accuracy reference: unmerged grid at high spp
    r0, rad0, var0 = rate_and_brf(0.0, SPP_ACC, reps=1)
    results = {"ref_unmerged": {"rate_at_acc_spp": r0}}
    for tol in [0.0, 3e-4, 1e-3, 3e-3, 1e-2]:
        rate, rad, var = rate_and_brf(tol, SPP, reps=3)
        if tol > 0.0:
            _, rad_a, var_a = rate_and_brf(tol, SPP_ACC, reps=1)
            z = np.abs(rad_a - rad0) / np.sqrt(var_a + var0 + 1e-30)
            rel = np.abs(rad_a - rad0) / np.maximum(np.abs(rad0), 1e-30)
            acc = {"max_z": float(z.max()), "max_rel": float(rel.max())}
        else:
            acc = {}
        results[f"tol_{tol:g}"] = {"rate": rate, **acc}
        print(json.dumps({f"tol_{tol:g}": results[f"tol_{tol:g}"]}), flush=True)
    print("FINAL " + json.dumps(results), flush=True)


if __name__ == "__main__":
    main()
