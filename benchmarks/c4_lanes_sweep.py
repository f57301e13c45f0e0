"""c4 rate with shell merge, vs lane-pool size."""

import time

import numpy as np

import eradiate_tpu as ert
import eradiate_tpu.ops.tracer_spherical as ts
from eradiate_tpu.core.rng import SeedState
from eradiate_tpu.experiments import AtmosphereExperiment
from eradiate_tpu.scenes.geometry import EARTH_RADIUS_KM

SPP = 131072


def make():
    return AtmosphereExperiment(
        geometry={"type": "spherical_shell", "shell_merge_tol": 1e-3},
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
    for lanes in (16384, 65536, 131072):
        ts.spherical_lanes_target = lambda n, s, _l=lanes: _l
        exp = make()
        exp.init()
        exp.process(spp=SPP, seed_state=SeedState(0), mesh=None)
        best = float("inf")
        for i in range(3):
            t0 = time.perf_counter()
            exp.process(spp=SPP, seed_state=SeedState(i + 1), mesh=None)
            best = min(best, time.perf_counter() - t0)
        n = 15 * SPP
        print(
            f"lanes={lanes:7d}: {best*1e3:8.1f} ms  "
            f"{n/best/1e6:7.2f} M samples/s",
            flush=True,
        )


if __name__ == "__main__":
    main()
