"""Mueller/Stokes calculus for polarized transport.

JAX equivalent of the reference's polarized variants (SURVEY §2.1:
``*_polarized`` modes, Mueller 4x4 path weights, Stokes reference-frame
rotation and the ``stokes`` integrator's meridian alignment,
``scenes/integrators/_core.py:67-92``).

Conventions
-----------
Stokes vectors (I, Q, U, V) are defined w.r.t. a unit reference basis
vector ``b`` perpendicular to the propagation direction ``d``: Q > 0 means
polarization along ``b``. Rotating the basis by angle ``phi`` around ``d``
(right-handed, looking *toward the receiver*, i.e. against propagation)
transforms S by the rotator R(phi) below. The Rayleigh phase matrix follows
Hansen & Travis (1974) with Chandrasekhar's depolarization, normalized so
the (0,0) element is the scalar phase function [1/sr].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "rotator",
    "rayleigh_mueller",
    "depolarizer",
    "default_basis",
    "rotate_basis_angle",
    "stokes_rotate_to_basis",
]


def rotator(phi):
    """Stokes rotation Mueller matrix R(phi) for a basis rotation by
    ``phi`` around the propagation direction."""
    c = jnp.cos(2.0 * phi)
    s = jnp.sin(2.0 * phi)
    z = jnp.zeros_like(c)
    o = jnp.ones_like(c)
    return jnp.stack(
        [
            jnp.stack([o, z, z, z], axis=-1),
            jnp.stack([z, c, s, z], axis=-1),
            jnp.stack([z, -s, c, z], axis=-1),
            jnp.stack([z, z, z, o], axis=-1),
        ],
        axis=-2,
    )


def rayleigh_mueller(cos_theta, depol):
    """Rayleigh scattering Mueller matrix [1/sr], reference frames in the
    scattering plane on both sides.

    Hansen & Travis (1974) eq. (2.15)-(2.16): with Delta = (1-rho)/(1+rho/2)
    and Delta' = (1-2 rho)/(1-rho),

    P = Delta * P_pure + (1 - Delta) * diag(1, 0, 0, 0) / (4 pi)
    with P44 of P_pure additionally scaled by Delta'.
    """
    c = cos_theta
    c2 = c * c
    norm = 3.0 / (16.0 * jnp.pi)
    delta = (1.0 - depol) / (1.0 + 0.5 * depol)
    delta_p = (1.0 - 2.0 * depol) / jnp.maximum(1.0 - depol, 1e-12)

    a = norm * (1.0 + c2)
    b = -norm * (1.0 - c2)
    d = 2.0 * norm * c
    z = jnp.zeros_like(c)
    iso = 1.0 / (4.0 * jnp.pi)

    m00 = delta * a + (1.0 - delta) * iso
    m01 = delta * b
    m11 = delta * a
    m22 = delta * d
    m33 = delta * delta_p * d

    return jnp.stack(
        [
            jnp.stack([m00, m01, z, z], axis=-1),
            jnp.stack([m01, m11, z, z], axis=-1),
            jnp.stack([z, z, m22, z], axis=-1),
            jnp.stack([z, z, z, m33], axis=-1),
        ],
        axis=-2,
    )


def depolarizer(value):
    """Ideal depolarizer Mueller matrix scaled by ``value`` (diffuse
    surfaces): only M00 nonzero."""
    z = jnp.zeros_like(value)
    row0 = jnp.stack([value, z, z, z], axis=-1)
    rowz = jnp.stack([z, z, z, z], axis=-1)
    return jnp.stack([row0, rowz, rowz, rowz], axis=-2)


def default_basis(d):
    """Deterministic reference basis perpendicular to ``d``.

    The meridian-plane basis when d is not parallel to z: b lies in the
    (d, z) plane ("vertical" polarization reference); falls back to x-axis
    at the poles.
    """
    z = jnp.zeros_like(d)
    z = z.at[..., 2].set(1.0)
    b = z - d * d[..., 2:3]
    n = jnp.linalg.norm(b, axis=-1, keepdims=True)
    fallback = jnp.zeros_like(d).at[..., 0].set(1.0)
    # orthogonalize fallback against d
    fb = fallback - d * d[..., 0:1]
    fb = fb / jnp.maximum(jnp.linalg.norm(fb, axis=-1, keepdims=True), 1e-12)
    return jnp.where(n > 1e-6, b / jnp.maximum(n, 1e-12), fb)


def rotate_basis_angle(d, b_from, b_to):
    """Signed angle rotating ``b_from`` onto ``b_to`` around ``d``.

    Both bases must be unit and perpendicular to ``d``. Positive sense:
    right-handed around d as seen looking against the propagation
    direction (the frame-rotation convention matching :func:`rotator`).
    """
    cosang = jnp.clip(jnp.sum(b_from * b_to, axis=-1), -1.0, 1.0)
    cross = jnp.cross(b_from, b_to)
    sinang = jnp.sum(cross * d, axis=-1)
    return jnp.arctan2(sinang, cosang)


def stokes_rotate_to_basis(S, d, b_from, b_to):
    """Re-express Stokes vector S from basis b_from to basis b_to."""
    phi = rotate_basis_angle(d, b_from, b_to)
    R = rotator(phi)
    return jnp.einsum(
        "...ij,...j->...i", R, S, precision=jax.lax.Precision.HIGHEST
    )
