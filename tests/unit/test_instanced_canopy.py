"""Instanced leaf sweeps == flattened sweeps.

The instanced path stores the canonical cloud once and sweeps the union
of translated copies (ops/canopy.InstancedLeafArrays; instance scan).
Since it tests the SAME disk set as the flattened cloud, nearest/occluded
results must agree exactly (up to exact f32 tie handling, measure-zero)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eradiate_tpu.ops.canopy import (
    InstancedLeafArrays,
    LeafCloudArrays,
    leaf_bounds,
    leaf_nearest,
    leaf_occluded,
    morton_order,
)


def _canonical(n=200, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    centers[:, 2] = rng.uniform(0.5, 3.0, n)
    order = morton_order(centers)
    normals = rng.normal(size=(n, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    return (
        centers[order].astype(np.float32),
        normals[order].astype(np.float32),
        np.full(n, 0.15, np.float32),
    )


def _instances(n_inst=6, seed=1):
    rng = np.random.default_rng(seed)
    off = rng.uniform(-15, 15, (n_inst, 3)).astype(np.float32)
    off[:, 2] = 0.0
    return off


def _rays(B=256, seed=2):
    """Rays from above, origins jittered around the instance centers so a
    healthy fraction actually intersects leaves."""
    rng = np.random.default_rng(seed)
    off = _instances()
    anchors = off[rng.integers(0, off.shape[0], B)]
    p = anchors + rng.uniform(-2.5, 2.5, (B, 3)).astype(np.float32)
    p[:, 2] = 25.0
    d = 0.06 * rng.normal(size=(B, 3)).astype(np.float32)
    d[:, 2] = -1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jnp.asarray(p.astype(np.float32)), jnp.asarray(d.astype(np.float32))


def _build():
    c, n, r = _canonical()
    off = _instances()
    canonical = LeafCloudArrays(
        centers=jnp.asarray(c), normals=jnp.asarray(n), radii=jnp.asarray(r)
    )
    inst = InstancedLeafArrays(
        canonical=canonical, offsets=jnp.asarray(off)
    )
    flat_centers = (c[None, :, :] + off[:, None, :]).reshape(-1, 3)
    flat = LeafCloudArrays(
        centers=jnp.asarray(flat_centers),
        normals=jnp.asarray(np.tile(n, (off.shape[0], 1))),
        radii=jnp.asarray(np.tile(r, off.shape[0])),
    )
    return inst, flat


class TestInstancedEqualsFlattened:
    def test_bounds(self):
        inst, flat = _build()
        lo_i, hi_i = leaf_bounds(inst)
        lo_f, hi_f = leaf_bounds(flat)
        np.testing.assert_allclose(np.asarray(lo_i), np.asarray(lo_f), atol=1e-5)
        np.testing.assert_allclose(np.asarray(hi_i), np.asarray(hi_f), atol=1e-5)

    def test_nearest(self):
        inst, flat = _build()
        p, d = _rays()
        t_max = jnp.full(p.shape[0], 100.0)
        t_i, n_i, h_i = jax.jit(leaf_nearest)(p, d, t_max, inst)
        t_f, n_f, h_f = jax.jit(leaf_nearest)(p, d, t_max, flat)
        np.testing.assert_array_equal(np.asarray(h_i), np.asarray(h_f))
        np.testing.assert_allclose(
            np.asarray(t_i), np.asarray(t_f), rtol=1e-5, atol=1e-6
        )
        hit = np.asarray(h_i)
        np.testing.assert_allclose(
            np.asarray(n_i)[hit], np.asarray(n_f)[hit], rtol=1e-4, atol=1e-5
        )
        assert hit.sum() > 20  # the scene actually exercises hits

    def test_occluded(self):
        inst, flat = _build()
        p, d = _rays(seed=5)
        t_max = jnp.full(p.shape[0], 100.0)
        o_i = jax.jit(leaf_occluded)(p, d, t_max, inst)
        o_f = jax.jit(leaf_occluded)(p, d, t_max, flat)
        np.testing.assert_array_equal(np.asarray(o_i), np.asarray(o_f))
        assert 0 < np.asarray(o_i).sum() < p.shape[0]


class TestInstancedTris:
    """Instanced triangle sweeps == flattened (tree trunks at scale)."""

    def _build(self, n_inst=5):
        from eradiate_tpu.ops.mesh import (
            InstancedTriArrays,
            cylinder_mesh,
            mesh_from_vertices,
        )

        v, f = cylinder_mesh(0.4, 3.0, n_seg=10)
        canonical = mesh_from_vertices(jnp.asarray(v, jnp.float32), f)
        off = _instances(n_inst, seed=11)
        inst = InstancedTriArrays(
            canonical=canonical, offsets=jnp.asarray(off)
        )
        # flattened soup
        vs = np.concatenate([np.asarray(v) + o[None, :] for o in off])
        fs = np.concatenate(
            [np.asarray(f) + i * len(v) for i in range(n_inst)]
        )
        flat = mesh_from_vertices(jnp.asarray(vs, jnp.float32), fs)
        return inst, flat, off

    def _rays_at(self, off, B=200, seed=13):
        rng = np.random.default_rng(seed)
        anchors = off[rng.integers(0, off.shape[0], B)]
        p = anchors + rng.uniform(-1.0, 1.0, (B, 3)).astype(np.float32)
        p[:, 2] = 20.0
        d = 0.04 * rng.normal(size=(B, 3)).astype(np.float32)
        d[:, 2] = -1.0
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return (
            jnp.asarray(p.astype(np.float32)),
            jnp.asarray(d.astype(np.float32)),
        )

    def test_nearest_and_occluded(self):
        """Unlike disks (robust containment test), triangle edge tests
        are exact-boundary sensitive: translating the RAY (instanced) vs
        translating the VERTICES (flattened) rounds differently in f32,
        so rays grazing shared edges may flip hit<->miss (~2% here).
        Common hits must agree tightly; flips must stay rare."""
        from eradiate_tpu.ops.mesh import tri_nearest, tri_occluded

        inst, flat, off = self._build()
        p, d = self._rays_at(off)
        t_max = jnp.full(p.shape[0], 50.0)
        t_i, n_i, h_i = jax.jit(tri_nearest)(p, d, t_max, inst)
        t_f, n_f, h_f = jax.jit(tri_nearest)(p, d, t_max, flat)
        h_i = np.asarray(h_i)
        h_f = np.asarray(h_f)
        flips = h_i != h_f
        assert flips.mean() < 0.05, flips.mean()
        both = h_i & h_f
        assert both.sum() > 15
        np.testing.assert_allclose(
            np.asarray(t_i)[both], np.asarray(t_f)[both],
            rtol=1e-4, atol=1e-5,
        )
        o_i = np.asarray(jax.jit(tri_occluded)(p, d, t_max, inst))
        o_f = np.asarray(jax.jit(tri_occluded)(p, d, t_max, flat))
        assert (o_i != o_f).mean() < 0.05
