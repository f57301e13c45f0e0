"""Multi-HOST distribution test: 2 OS processes x 4 CPU devices.

The reference is strictly single-host; this exercises this build's
``jax.distributed`` path end to end over localhost TCP (the CPU stand-in
for the network between hosts): every process holds the same host-side
scene, inputs are placed as global arrays (``parallel.render._put_global``),
the render runs on the global 8-device ("spectral", "sample") mesh, and
outputs gather to every host (``_fetch``/``process_allgather``). Global sample-id slicing
makes the 2-host result equal the single-device render up to float
summation order.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

_WORKER = textwrap.dedent(
    """
    import sys, os
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 4)
    pid = int(sys.argv[1])
    port = sys.argv[2]
    out_path = sys.argv[3]
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=2,
        process_id=pid,
    )
    assert jax.process_count() == 2
    assert jax.device_count() == 8

    sys.path.insert(0, os.getcwd())
    import numpy as np
    import jax.numpy as jnp

    from eradiate_tpu.core.frame import angles_to_direction
    from eradiate_tpu.ops.medium import cumulative_tau
    from eradiate_tpu.ops.scene_state import (
        IlluminationArrays, MediumArrays, SceneArrays, SceneConfig,
        SensorArrays, SurfaceArrays,
    )
    from eradiate_tpu.parallel import make_render_mesh, render_sharded

    S, n_layers, n_pix = 2, 8, 4
    z_levels = jnp.linspace(0.0, 100.0, n_layers + 1)
    sigma_t = jnp.full((S, n_layers), 2e-3)
    med = MediumArrays(
        z_levels=z_levels,
        tau_levels=cumulative_tau(sigma_t, z_levels),
        albedo=jnp.full((S, n_layers), 0.9),
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
    dirs = angles_to_direction(
        np.stack([np.deg2rad(np.linspace(-60, 60, n_pix)),
                  np.zeros(n_pix)], axis=-1)
    )
    sensor = SensorArrays(
        directions=jnp.asarray(dirs), target=jnp.zeros(3),
        ray_offset=jnp.nan,
    )
    # mesh over the GLOBAL device list: spectral axis spans hosts,
    # sample axis within hosts
    mesh = make_render_mesh(2, 4)
    result = render_sharded(
        scene, sensor, SceneConfig(), spp=32, seed=11, mesh=mesh
    )
    if pid == 0:
        np.savez(out_path, radiance=result["radiance"], m2=result["m2"])
    jax.distributed.shutdown()
    print("WORKER_OK", pid)
    """
)


@pytest.mark.slow
def test_two_host_render_matches_single_device(tmp_path):
    out_path = tmp_path / "mh_result.npz"
    port = "12387"
    env = {
        **os.environ,
        "JAX_PLATFORMS": "cpu",
        "ERADIATE_TPU_MESH": "none",
    }
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(i), port, str(out_path)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            cwd=os.path.join(os.path.dirname(__file__), "..", ".."),
            env=env,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=420)
        outs.append(out)
    for i, out in enumerate(outs):
        assert f"WORKER_OK {i}" in out, f"worker {i} failed:\n{out[-2000:]}"
    assert out_path.exists()
    got = np.load(out_path)

    # single-device reference (same seed): must match up to summation order
    import jax

    from eradiate_tpu.ops import SceneConfig
    from eradiate_tpu.ops.tracer import render

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "unit"))
    from test_tracer import make_scene, make_sensor

    scene = make_scene(sigma_t=2e-3, albedo=0.9, reflectance=0.5, S=2)
    sensor = make_sensor(np.linspace(-60, 60, 4))
    ref = render(scene, sensor, SceneConfig(), spp=32, seed=11)
    np.testing.assert_allclose(
        got["radiance"], np.asarray(ref["radiance"]), rtol=3e-5, atol=1e-7
    )
