"""RAMI-scale canopy benchmark: 1e6 leaf disks.

Builds an actual-canopy-sized scene — ``--instances`` sphere-crown
instances of a ``--leaves-per-tree``-disk canonical cloud, Morton-ordered
— and measures canopy-tracer samples/s (target: >0.05 M samples/s at 1e6
disks without running out of device memory). Memory scales with leaf
count, not rays x leaves: the sweep scans 512-leaf chunks
(``ops/canopy._scan_chunks``), and instanced clouds store the canonical
cloud once and scan the instance offsets.

Usage: python benchmarks/canopy_scale.py [--instances 500]
       [--leaves-per-tree 2000] [--spp 1024] [--cpu] [--instanced]

GPU rates: not measured. At fixed leaf count the dense sweep's
per-bounce cost is ~B x N, so instancing, not flattening, is the 1e6-disk
path.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def build(n_instances, leaves_per_tree, n_pix, seed=7, instanced=False):
    import jax.numpy as jnp

    from eradiate_tpu.core.frame import angles_to_direction
    from eradiate_tpu.ops.canopy import LeafCloudArrays, morton_order
    from eradiate_tpu.ops.medium import cumulative_tau
    from eradiate_tpu.ops.scene_state import (
        IlluminationArrays,
        MediumArrays,
        SceneArrays,
        SceneConfig,
        SensorArrays,
        SurfaceArrays,
    )
    from eradiate_tpu.scenes.biosphere import DiscreteCanopy, LeafCloud

    rng = np.random.default_rng(seed)
    # canonical crown: spherical cloud, 5 m radius, 10 m height
    cloud = LeafCloud.sphere(
        n_leaves=leaves_per_tree,
        leaf_radius=0.1,
        radius=5.0,
        center=(0.0, 0.0, 10.0),
        seed=seed,
        leaf_reflectance=0.45,
        leaf_transmittance=0.3,
    )
    # forest stand: instances on a ~square-km plot
    side_m = 40.0 * np.sqrt(n_instances)  # ~25 trees/ha
    positions = np.column_stack([
        rng.uniform(-side_m / 2, side_m / 2, n_instances),
        rng.uniform(-side_m / 2, side_m / 2, n_instances),
        np.zeros(n_instances),
    ]) * 1e-3
    canopy = DiscreteCanopy(
        size=(side_m, side_m, 15.0),
        instanced_canopy_elements=[
            {
                "type": "instanced",
                "canopy_element": cloud,
                "instance_positions": positions,
            }
        ],
    )
    dtype = jnp.float32
    if instanced:
        from eradiate_tpu.ops.canopy import InstancedLeafArrays

        order = morton_order(cloud.positions)
        leaves = InstancedLeafArrays(
            canonical=LeafCloudArrays(
                centers=jnp.asarray(cloud.positions[order], dtype=dtype),
                normals=jnp.asarray(cloud.orientations[order], dtype=dtype),
                radii=jnp.asarray(cloud.radii[order], dtype=dtype),
            ),
            offsets=jnp.asarray(positions, dtype=dtype),
        )
    else:
        flat = canopy.flatten()
        order = morton_order(flat.positions)
        leaves = LeafCloudArrays(
            centers=jnp.asarray(flat.positions[order], dtype=dtype),
            normals=jnp.asarray(flat.orientations[order], dtype=dtype),
            radii=jnp.asarray(flat.radii[order], dtype=dtype),
        )
    leaf_params = {
        "reflectance": jnp.full(1, 0.45, dtype),
        "transmittance": jnp.full(1, 0.3, dtype),
    }

    z_levels = jnp.linspace(0.0, 100.0, 3)
    sigma = jnp.zeros((1, 2))
    med = MediumArrays(
        z_levels=z_levels,
        tau_levels=cumulative_tau(sigma, z_levels),
        albedo=jnp.ones((1, 2)),
        phase_weights=jnp.ones((1, 1, 2)),
        phase_params=({"depol": jnp.zeros((1, 2))},),
    )
    surf = SurfaceArrays(params={"reflectance": jnp.full(1, 0.15)})
    d_sun = -angles_to_direction([np.deg2rad(30.0), 0.0])[0]
    illum = IlluminationArrays(
        direction=jnp.asarray(d_sun),
        irradiance=jnp.ones(1),
        cos_cutoff=1.0,
        sky_radiance=jnp.zeros(1),
    )
    scene = SceneArrays(medium=med, surface=surf, illumination=illum)
    vzas = np.linspace(-60, 60, n_pix)
    dirs = angles_to_direction(
        np.stack([np.deg2rad(vzas), np.zeros(n_pix)], axis=-1)
    )
    side_km = side_m * 1e-3
    sensor = SensorArrays(
        directions=jnp.asarray(dirs),
        target=jnp.zeros(3),
        ray_offset=jnp.asarray(50.0),
        target_extent=jnp.asarray([side_km, side_km]),
    )
    return scene, leaf_params, leaves, sensor, SceneConfig(max_depth=8)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--instances", type=int, default=500)
    ap.add_argument("--leaves-per-tree", type=int, default=2000)
    ap.add_argument("--pixels", type=int, default=19)
    ap.add_argument("--spp", type=int, default=1024)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--instanced", action="store_true",
                    help="virtual-block instanced sweeps (canonical cloud stored once)")
    args = ap.parse_args()

    import jax

    if args.cpu:
        try:
            jax.config.update("jax_platforms", "cpu")
        except RuntimeError:
            pass

    from eradiate_tpu.ops.tracer_canopy import render_canopy

    scene, leaf_params, leaves, sensor, config = build(
        args.instances, args.leaves_per_tree, args.pixels,
        instanced=args.instanced,
    )
    from eradiate_tpu.ops.canopy import InstancedLeafArrays
    if isinstance(leaves, InstancedLeafArrays):
        n_leaves = int(
            leaves.canonical.radii.shape[0] * leaves.offsets.shape[0]
        )
    else:
        n_leaves = int(leaves.radii.shape[0])

    def once(seed):
        out = render_canopy(
            scene, leaf_params, leaves, sensor, config, spp=args.spp,
            seed=seed,
        )
        np.asarray(out["radiance"])
        return out

    t0 = time.perf_counter()
    once(0)
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for i in range(args.reps):
        once(i + 1)
    dt = (time.perf_counter() - t0) / args.reps
    rate = args.pixels * args.spp / dt
    print(json.dumps({
        "metric": "canopy_samples_per_s",
        "instanced": args.instanced,
        "n_leaves": n_leaves,
        "backend": jax.default_backend(),
        "value": round(rate, 1),
        "unit": "samples/s",
        "compile_s": round(compile_s, 1),
        "wall_s_per_render": round(dt, 2),
        "target": 5e4,
        "vs_target": round(rate / 5e4, 3),
    }))


if __name__ == "__main__":
    main()
