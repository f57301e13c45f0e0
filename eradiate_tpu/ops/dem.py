"""Digital elevation model (heightfield) intersection.

JAX replacement for the reference's triangulated DEM meshes
(``scenes/surface/_dem.py:475``, ``mesh_from_dem``): instead of a triangle
BVH, the terrain is a bilinear heightfield h(x, y) on a regular grid,
intersected by bounded ray marching with bisection refinement — fixed
iteration counts, fully vectorized over the path batch.

Heights and coordinates in km. Outside the grid extent the terrain
continues at the edge elevation (clamped lookup).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "DemArrays",
    "dem_height",
    "dem_normal",
    "dem_intersect",
    "mesh_from_dem",
]

from .scene_state import _pytree_dataclass
from typing import Any


@_pytree_dataclass
class DemArrays:
    heights: Any  # [Ny, Nx]
    x0: Any  # scalar: west edge
    y0: Any  # scalar: south edge
    dx: Any  # scalar: grid spacing x
    dy: Any  # scalar


def dem_height(dem: DemArrays, x, y):
    """Bilinear height lookup h(x, y) with edge clamping."""
    h = dem.heights
    ny, nx = h.shape
    u = (x - dem.x0) / dem.dx
    v = (y - dem.y0) / dem.dy
    i = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, nx - 2)
    j = jnp.clip(jnp.floor(v).astype(jnp.int32), 0, ny - 2)
    fu = jnp.clip(u - i, 0.0, 1.0)
    fv = jnp.clip(v - j, 0.0, 1.0)
    h00 = h[j, i]
    h01 = h[j, i + 1]
    h10 = h[j + 1, i]
    h11 = h[j + 1, i + 1]
    return (
        h00 * (1 - fu) * (1 - fv)
        + h01 * fu * (1 - fv)
        + h10 * (1 - fu) * fv
        + h11 * fu * fv
    )


def dem_normal(dem: DemArrays, x, y):
    """Upward surface normal from central differences of the heightfield."""
    eps_x = dem.dx * 0.5
    eps_y = dem.dy * 0.5
    dhdx = (dem_height(dem, x + eps_x, y) - dem_height(dem, x - eps_x, y)) / (
        2.0 * eps_x
    )
    dhdy = (dem_height(dem, x, y + eps_y) - dem_height(dem, x, y - eps_y)) / (
        2.0 * eps_y
    )
    n = jnp.stack([-dhdx, -dhdy, jnp.ones_like(dhdx)], axis=-1)
    return n / jnp.linalg.norm(n, axis=-1, keepdims=True)


def dem_intersect(dem: DemArrays, p, d, t_max, n_march: int = 128, n_bisect: int = 16):
    """First crossing of z = h(x, y) along p + t d, t in (0, t_max].

    Fixed-step march (n_march steps over [0, t_max]) + bisection refine.
    Returns (t_hit, hit). Steps shorter than the terrain features may miss
    grazing silhouettes; n_march trades accuracy for cost.
    """
    B = p.shape[0]
    # overshoot the segment slightly: candidate distances computed in f32
    # can land the endpoint marginally above a grazed surface
    dt = (t_max * 1.02 + 1e-4) / n_march

    def sdf(t):
        q = p + d * t[:, None]
        return q[:, 2] - dem_height(dem, q[:, 0], q[:, 1])

    s0 = sdf(jnp.full(B, 1e-6))

    def march_body(k, state):
        t_lo, t_hi, found = state
        t = dt * (k + 1)
        s = sdf(t)
        cross = (~found) & (jnp.sign(s) != jnp.sign(s0)) & (s0 != 0.0)
        t_hi = jnp.where(cross, t, t_hi)
        t_lo = jnp.where(cross, t - dt, t_lo)
        return t_lo, t_hi, found | cross

    t_lo, t_hi, found = jax.lax.fori_loop(
        0, n_march, march_body, (jnp.zeros(B), jnp.zeros(B), jnp.zeros(B, bool))
    )

    def bisect_body(_, state):
        t_lo, t_hi = state
        t_mid = 0.5 * (t_lo + t_hi)
        s = sdf(t_mid)
        same = jnp.sign(s) == jnp.sign(s0)
        t_lo = jnp.where(same, t_mid, t_lo)
        t_hi = jnp.where(same, t_hi, t_mid)
        return t_lo, t_hi

    t_lo, t_hi = jax.lax.fori_loop(0, n_bisect, bisect_body, (t_lo, t_hi))
    t_hit = 0.5 * (t_lo + t_hi)
    return jnp.where(found, t_hit, t_max), found


def mesh_from_dem(heights, x0, y0, dx, dy, dtype=None):
    """Triangulate a heightfield into a
    :class:`~eradiate_tpu.ops.mesh.TriangleMeshArrays` (two triangles per
    grid cell, consistent diagonal).

    The reference's approach to DEM rendering
    (``/root/reference/src/eradiate/scenes/surface/_dem.py:475``,
    ``mesh_from_dem``): the exact triangle intersector replaces the
    marched bilinear surface. Used as the exactness cross-gate for the
    marcher (``tests/system/test_dem.py``): the two surfaces differ only
    by the bilinear-vs-planar in-cell deviation, bounded by
    ``|h00 - h01 - h10 + h11| / 4`` per cell, so their BRFs must agree
    within MC noise on grids resolving the terrain.
    """
    import numpy as np

    h = np.asarray(heights, dtype=np.float64)
    ny, nx = h.shape
    xs = np.asarray(x0, dtype=np.float64) + np.arange(nx) * float(dx)
    ys = np.asarray(y0, dtype=np.float64) + np.arange(ny) * float(dy)
    X, Y = np.meshgrid(xs, ys)  # [Ny, Nx]
    verts = np.stack([X.ravel(), Y.ravel(), h.ravel()], axis=-1)

    idx = np.arange(ny * nx).reshape(ny, nx)
    a = idx[:-1, :-1].ravel()  # (j, i)
    b = idx[:-1, 1:].ravel()  # (j, i+1)
    c = idx[1:, :-1].ravel()  # (j+1, i)
    e = idx[1:, 1:].ravel()  # (j+1, i+1)
    faces = np.concatenate(
        [np.stack([a, b, c], axis=-1), np.stack([e, c, b], axis=-1)],
        axis=0,
    )

    from .mesh import mesh_from_vertices

    if dtype is None:
        dtype = jnp.result_type(float)
    return mesh_from_vertices(jnp.asarray(verts, dtype=dtype), faces)
