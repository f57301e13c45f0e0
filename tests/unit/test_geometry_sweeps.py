"""Dense leaf-disk and triangle sweeps vs a float64 numpy brute force.

``ops/canopy`` and ``ops/mesh`` test every (ray, primitive) pair in
fixed-size chunks; here the same pairs are tested one by one in float64
with no chunking, so padding, the min/any reductions and the winner's
normal are all checked against an independent implementation.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from eradiate_tpu.ops.canopy import (
    LeafCloudArrays,
    leaf_nearest,
    leaf_occluded,
    ray_leaves_nearest,
    ray_leaves_occluded,
)
from eradiate_tpu.ops.mesh import (
    TriangleMeshArrays,
    ray_tris_nearest,
    ray_tris_occluded,
    tri_nearest,
    tri_occluded,
)

EPS_T = 1e-7


def _leaf_problem(B, N, seed):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-1, 1, (B, 3)).astype(np.float32)
    p[:, 2] = 2.0  # above the cloud
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 0.3  # downward
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    centers = rng.uniform(-1, 1, (N, 3)).astype(np.float32)
    normals = rng.normal(size=(N, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    radii = rng.uniform(0.05, 0.2, N).astype(np.float32)
    prims = (centers, normals, radii)
    return p, d, np.full(B, 10.0, np.float32), prims


def _tri_problem(B, N, seed):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-0.02, 0.02, (N, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.004, (N, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.004, (N, 3)).astype(np.float32)
    p = rng.uniform(-0.03, 0.03, (B, 3)).astype(np.float32)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return p, d, np.full(B, 0.1, np.float32), (v0, e1, e2)


def _leaf_ref(p, d, t_max, prims):
    """[B, N] hit distances (inf = miss) and per-primitive normals, f64."""
    c, n, r = (np.asarray(a, np.float64) for a in prims)
    p, d = np.asarray(p, np.float64), np.asarray(d, np.float64)
    dn = d @ n.T
    safe = np.where(np.abs(dn) > 1e-12, dn, 1e-12)
    t = (np.sum(c * n, axis=1)[None, :] - p @ n.T) / safe
    q = p[:, None, :] + d[:, None, :] * t[..., None]
    inside = np.sum((q - c[None]) ** 2, axis=-1) <= (r * r)[None, :]
    ok = (t > EPS_T) & (t < np.asarray(t_max)[:, None]) & inside
    return np.where(ok & (np.abs(dn) > 1e-12), t, np.inf), n


def _tri_ref(p, d, t_max, prims):
    v0, e1, e2 = (np.asarray(a, np.float64) for a in prims)
    p, d = np.asarray(p, np.float64), np.asarray(d, np.float64)
    pvec = np.cross(d[:, None, :], e2[None])
    det = np.sum(e1[None] * pvec, axis=-1)
    inv = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det), 0)
    tvec = p[:, None, :] - v0[None]
    u = np.sum(tvec * pvec, axis=-1) * inv
    qvec = np.cross(tvec, e1[None])
    v = np.sum(d[:, None, :] * qvec, axis=-1) * inv
    t = np.sum(e2[None] * qvec, axis=-1) * inv
    ok = (
        (np.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1)
        & (t > EPS_T) & (t < np.asarray(t_max)[:, None])
    )
    n = np.cross(e1, e2)
    return np.where(ok, t, np.inf), n / np.linalg.norm(n, axis=1)[:, None]


KINDS = {
    "leaf": dict(
        problem=_leaf_problem, ref=_leaf_ref,
        arrays=lambda c, n, r: LeafCloudArrays(
            centers=jnp.asarray(c), normals=jnp.asarray(n),
            radii=jnp.asarray(r),
        ),
        nearest=ray_leaves_nearest, occluded=ray_leaves_occluded,
        nearest_adv=leaf_nearest, occluded_adv=leaf_occluded,
        sizes=(100, 300),
    ),
    "tri": dict(
        problem=_tri_problem, ref=_tri_ref,
        arrays=lambda v0, e1, e2: TriangleMeshArrays(
            jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2)
        ),
        nearest=ray_tris_nearest, occluded=ray_tris_occluded,
        nearest_adv=tri_nearest, occluded_adv=tri_occluded,
        sizes=(700, 900),
    ),
}


def _inputs(kind, B=None, N=None, seed=2):
    k = KINDS[kind]
    B = B or k["sizes"][0]
    N = N or k["sizes"][1]
    p, d, t_max, prims = k["problem"](B, N, seed)
    return k, p, d, t_max, prims


def _check_nearest(k, p, d, t_max, prims, out, min_hits=10):
    t_ref_all, n_ref_all = k["ref"](p, d, t_max, prims)
    hit_ref = np.isfinite(t_ref_all.min(axis=1))
    t, n, hit = (np.asarray(a) for a in out)
    # grazing rays may flip between f32 and f64; they must stay rare
    flips = hit != hit_ref
    assert flips.mean() < 0.01, flips.mean()
    both = hit & hit_ref
    assert both.sum() >= min_hits  # the problem exercises hits
    win = t_ref_all.argmin(axis=1)
    np.testing.assert_allclose(
        t[both], t_ref_all.min(axis=1)[both], rtol=1e-5, atol=1e-7
    )
    np.testing.assert_allclose(n[both], n_ref_all[win][both], atol=1e-4)
    np.testing.assert_array_equal(t[~hit], t_max[~hit])
    return hit_ref


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_nearest_matches_f64_reference(kind):
    k, p, d, t_max, prims = _inputs(kind)
    out = k["nearest"](
        jnp.asarray(p), jnp.asarray(d), jnp.asarray(t_max),
        k["arrays"](*prims),
    )
    _check_nearest(k, p, d, t_max, prims, out)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_occluded_matches_f64_reference(kind):
    k, p, d, t_max, prims = _inputs(kind, seed=5)
    occ = np.asarray(k["occluded"](
        jnp.asarray(p), jnp.asarray(d), jnp.asarray(t_max),
        k["arrays"](*prims),
    ))
    t_ref_all, _ = k["ref"](p, d, t_max, prims)
    occ_ref = np.isfinite(t_ref_all).any(axis=1)
    assert (occ != occ_ref).mean() < 0.01
    assert 0 < occ_ref.sum() < occ_ref.size


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_all_miss(kind):
    k, p, d, t_max, prims = _inputs(kind, B=16, N=32)
    d = np.zeros_like(d)
    d[:, 2] = 1.0
    p = p.copy()
    p[:, 2] = 5.0  # above everything, looking up
    t, _, hit = k["nearest"](
        jnp.asarray(p), jnp.asarray(d), jnp.asarray(t_max),
        k["arrays"](*prims),
    )
    assert not np.any(np.asarray(hit))
    np.testing.assert_array_equal(np.asarray(t), t_max)
    occ = k["occluded"](
        jnp.asarray(p), jnp.asarray(d), jnp.asarray(t_max),
        k["arrays"](*prims),
    )
    assert not np.any(np.asarray(occ))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_sizes_not_multiple_of_chunk(kind):
    """N = 53 primitives in chunks of 16: the padded tail never hits."""
    k, p, d, t_max, prims = _inputs(kind, B=37, N=53)
    args = (jnp.asarray(p), jnp.asarray(d), jnp.asarray(t_max),
            k["arrays"](*prims))
    out = k["nearest"](*args, chunk=16)
    _check_nearest(k, p, d, t_max, prims, out, min_hits=1)
    # the chunking must not change the answer
    full = k["nearest"](*args, chunk=64)
    for a, b in zip(out, full):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    occ = np.asarray(k["occluded"](*args, chunk=16))
    np.testing.assert_array_equal(occ, np.asarray(k["occluded"](*args)))
    assert np.all(occ[np.asarray(out[2])])


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_aabb_advance_matches_raw_sweep(kind):
    """The public entry points advance ray origins to the primitives'
    AABB; distances re-offset by the advance must match the raw sweep."""
    k, p, d, t_max, prims = _inputs(kind, B=300, N=200, seed=5)
    args = (jnp.asarray(p), jnp.asarray(d), jnp.asarray(t_max),
            k["arrays"](*prims))
    t_ref, _, hit_ref = (np.asarray(a) for a in k["nearest"](*args))
    t_adv, _, hit_adv = (np.asarray(a) for a in k["nearest_adv"](*args))
    np.testing.assert_array_equal(hit_adv, hit_ref)
    np.testing.assert_allclose(
        t_adv[hit_ref], t_ref[hit_ref], rtol=1e-4, atol=1e-6
    )
    np.testing.assert_array_equal(
        np.asarray(k["occluded_adv"](*args)),
        np.asarray(k["occluded"](*args)),
    )
