"""Device-facing setup that the CPU suite can still pin: the persistent
compile-cache location, the roofline peak table, and ``chip_smoke.py``
refusing to report a result without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))


def _child_env(**extra):
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("JAX_COMPILATION_CACHE_DIR",
                     "ERADIATE_TPU_COMPILATION_CACHE")
    }
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


@pytest.mark.parametrize("user_dir", [True, False], ids=["set", "unset"])
def test_compile_cache_dir(user_dir, tmp_path):
    """A user-set JAX_COMPILATION_CACHE_DIR is used as is; without it the
    cache lives in the checkout under a host fingerprint."""
    from eradiate_tpu import config

    env = _child_env(PYTHONPATH=REPO)
    if user_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    out = subprocess.run(
        [sys.executable, "-c",
         "import eradiate_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120, check=True,
    ).stdout.strip().splitlines()[-1]
    if user_dir:
        assert out == str(tmp_path / "cache")
    else:
        root = os.path.join(REPO, ".jax_cache")
        assert out == os.path.join(root, config._host_fingerprint())
        assert str(config.DEFAULT_CACHE_ROOT) == root
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


def test_device_peaks_lookup():
    from eradiate_tpu.profiling import device_peaks, kernel_roofline

    peaks = device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["hbm_bytes_per_s"] == 3.35e12
    assert peaks["bf16_flop_per_s"] == 989e12
    row = kernel_roofline(
        "k", 1e-3, flops=67e9 * 0.5, bytes_moved=3.35e9 * 0.25,
        device_kind="NVIDIA H100 80GB HBM3",
    )
    assert row["bound"] == "compute"
    assert row["speed_of_light_frac"] == pytest.approx(0.5)


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", "NVIDIA H100 PCIe"])
def test_device_peaks_unknown_kind_raises(kind):
    from eradiate_tpu.profiling import device_peaks, kernel_roofline

    with pytest.raises(ValueError, match="no published peaks"):
        device_peaks(kind)
    with pytest.raises(ValueError):
        kernel_roofline("k", 1.0, 1.0, 1.0, device_kind=kind)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    """On a CPU-only host (and from a directory that holds the script and
    nothing else of the repo) chip_smoke exits non-zero and prints no
    result line."""
    if where == "repo":
        script, cwd = os.path.join(REPO, "chip_smoke.py"), REPO
    else:
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), script)
        cwd = str(tmp_path)
    r = subprocess.run(
        [sys.executable, script], cwd=cwd, env=_child_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_multihost_passes_local_device_ids(monkeypatch):
    """ERADIATE_TPU_LOCAL_DEVICE_IDS reaches jax.distributed.initialize,
    so each of several processes on one host opens only its own card."""
    import jax

    from eradiate_tpu.parallel import multihost

    seen = {}
    monkeypatch.setattr(
        jax.distributed, "initialize", lambda **kw: seen.update(kw)
    )
    monkeypatch.setattr(multihost, "_initialized", False)
    monkeypatch.setenv("ERADIATE_TPU_COORDINATOR", "localhost:12345")
    monkeypatch.setenv("ERADIATE_TPU_NUM_PROCESSES", "2")
    monkeypatch.setenv("ERADIATE_TPU_PROCESS_ID", "1")
    monkeypatch.setenv("ERADIATE_TPU_LOCAL_DEVICE_IDS", "1")
    assert multihost.initialize() is False  # the stub starts no cluster
    assert seen == {
        "coordinator_address": "localhost:12345",
        "num_processes": 2,
        "process_id": 1,
        "local_device_ids": [1],
    }
