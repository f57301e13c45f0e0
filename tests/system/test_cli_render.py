"""CLI render entry: single-process and true 2-process multi-host runs.

A multi-process launch must be
``ERADIATE_TPU_COORDINATOR=... python -m eradiate_tpu.cli render ...``
with no user code.  The 2-process case runs the real CLI module in two
OS processes over localhost TCP and checks both exit cleanly with only
the coordinator writing output.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

_CONFIG = {
    "mode": "mono_single",
    "illumination": {"type": "directional", "zenith": 30.0, "azimuth": 0.0},
    "measures": {
        "type": "mdistant",
        "construct": "hplane",
        "zeniths": [-30.0, 0.0, 30.0],
        "azimuth": 0.0,
        "spp": 16,
        "id": "m",
    },
    "surface": {"type": "lambertian", "reflectance": 0.5},
}

_REPO = os.path.join(os.path.dirname(__file__), "..", "..")


def _run_cli(cfg_path, out_path, extra_env, mesh="auto", timeout=600):
    env = dict(os.environ)
    env.update(extra_env)
    return subprocess.run(
        [
            sys.executable, "-m", "eradiate_tpu.cli", "render",
            str(cfg_path), "-o", str(out_path), "--mesh", mesh,
            "--platform", "cpu", "--cpu-devices", "4",
        ],
        capture_output=True, text=True, timeout=timeout,
        cwd=os.path.abspath(_REPO), env=env,
    )


@pytest.fixture
def cfg_file(tmp_path):
    p = tmp_path / "scene.json"
    p.write_text(json.dumps(_CONFIG))
    return p


def _cpu_env(n_devices):
    # the platform itself is forced through the CLI's --platform flag
    # (config API, which wins over the JAX_PLATFORMS env var)
    return {"ERADIATE_TPU_MESH": ""}


class TestCliRender:
    def test_single_process_auto_mesh(self, cfg_file, tmp_path):
        out = tmp_path / "res.npz"
        r = _run_cli(cfg_file, out, _cpu_env(4))
        assert r.returncode == 0, r.stderr[-2000:]
        assert out.exists()
        data = np.load(out, allow_pickle=True)
        assert any("brf" in k for k in data.files), data.files

    def test_two_process_multihost(self, cfg_file, tmp_path):
        port = 12411
        procs = []
        outs = [tmp_path / f"res{i}.npz" for i in range(2)]
        for pid in range(2):
            env = dict(os.environ)
            env.update(_cpu_env(2))
            env.update({
                "ERADIATE_TPU_COORDINATOR": f"localhost:{port}",
                "ERADIATE_TPU_NUM_PROCESSES": "2",
                "ERADIATE_TPU_PROCESS_ID": str(pid),
            })
            procs.append(subprocess.Popen(
                [
                    sys.executable, "-m", "eradiate_tpu.cli", "render",
                    str(cfg_file), "-o", str(outs[pid]), "--mesh", "auto",
                    "--platform", "cpu", "--cpu-devices", "2",
                ],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=os.path.abspath(_REPO), env=env,
            ))
        results = [p.communicate(timeout=900) for p in procs]
        for p, (so, se) in zip(procs, results):
            assert p.returncode == 0, se[-2000:]
        # only the coordinator (process 0) writes results
        assert outs[0].exists()
        assert not outs[1].exists()
        data = np.load(outs[0], allow_pickle=True)
        assert any("brf" in k for k in data.files), data.files
