"""Polarized surface reflection: Mueller-matrix BRDFs.

JAX equivalents of the reference's polarized surface plugins
(``maignan``, ``scenes/bsdfs/_maignan.py:105``; ``ocean_mishchenko``,
``scenes/bsdfs/_ocean_mishchenko.py``). Scalar kinds reduce to ideal
depolarizers, so :func:`surface_mueller` is the single dispatch point used
by the polarized tracer for every surface.

Frame convention: matrices are expressed with both reference bases **in the
plane of incidence** (the plane spanned by the incident and outgoing
propagation directions) — the same "parallel" convention as the scattering
frames of :func:`eradiate_tpu.ops.mueller.rayleigh_mueller`; Q > 0 means
polarization along the in-plane (p) basis.

Complex Fresnel coefficients are computed with explicit real/imaginary
arithmetic (no complex dtypes — f32/f64 agnostic).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax.scipy.special import erfc

from .bsdf_ops import bsdf_eval, rpv_eval
from .mueller import depolarizer

__all__ = [
    "POLARIZED_SURFACES",
    "fresnel_mueller_elements",
    "maignan_mueller",
    "ocean_mishchenko_mueller",
    "maignan_eval",
    "ocean_mishchenko_eval",
    "surface_mueller",
]

POLARIZED_SURFACES = ("maignan", "ocean_mishchenko")


def _mu(w):
    return jnp.maximum(w[..., 2], 0.0)


def fresnel_mueller_elements(cos_i, m_re, m_im):
    """Fresnel reflection Mueller elements at incidence cosine ``cos_i``
    for relative complex refractive index ``m = m_re + i m_im``.

    Returns (a, b, c, d) with the matrix

        [[a, b, 0, 0], [b, a, 0, 0], [0, 0, c, d], [0, 0, -d, c]]

    where a = (Rp + Rs)/2, b = (Rp - Rs)/2, c = Re(rp conj(rs)),
    d = Im(rp conj(rs)); Q is referenced to the in-plane (p) basis.
    """
    cos_i = jnp.clip(cos_i, 1e-6, 1.0)
    sin2 = 1.0 - cos_i * cos_i

    # m^2 (complex), w = m^2 - sin^2(theta_i)
    m2_re = m_re * m_re - m_im * m_im
    m2_im = 2.0 * m_re * m_im
    w_re = m2_re - sin2
    w_im = m2_im

    # c2 = sqrt(w) = m * cos(theta_t), principal branch (Im >= 0 for
    # absorbing media)
    mod = jnp.sqrt(jnp.maximum(w_re * w_re + w_im * w_im, 1e-30))
    c2_re = jnp.sqrt(jnp.maximum((mod + w_re) / 2.0, 0.0))
    c2_im = jnp.sign(w_im + 1e-30) * jnp.sqrt(jnp.maximum((mod - w_re) / 2.0, 0.0))

    # rs = (cos_i - c2) / (cos_i + c2)
    def cdiv(ar, ai, br, bi):
        den = jnp.maximum(br * br + bi * bi, 1e-30)
        return (ar * br + ai * bi) / den, (ai * br - ar * bi) / den

    rs_re, rs_im = cdiv(cos_i - c2_re, -c2_im, cos_i + c2_re, c2_im)

    # rp = (m^2 cos_i - c2) / (m^2 cos_i + c2)
    a_re = m2_re * cos_i - c2_re
    a_im = m2_im * cos_i - c2_im
    b_re = m2_re * cos_i + c2_re
    b_im = m2_im * cos_i + c2_im
    rp_re, rp_im = cdiv(a_re, a_im, b_re, b_im)

    Rs = rs_re * rs_re + rs_im * rs_im
    Rp = rp_re * rp_re + rp_im * rp_im
    a = 0.5 * (Rp + Rs)
    b = 0.5 * (Rp - Rs)
    # rp * conj(rs)
    c = rp_re * rs_re + rp_im * rs_im
    d = rp_im * rs_re - rp_re * rs_im
    return a, b, c, d


def _fresnel_mueller_matrix(cos_i, m_re, m_im):
    a, b, c, d = fresnel_mueller_elements(cos_i, m_re, m_im)
    z = jnp.zeros_like(a)
    return jnp.stack(
        [
            jnp.stack([a, b, z, z], axis=-1),
            jnp.stack([b, a, z, z], axis=-1),
            jnp.stack([z, z, c, d], axis=-1),
            jnp.stack([z, z, -d, c], axis=-1),
        ],
        axis=-2,
    )


def _facet_geometry(wi, wo):
    """Specular facet geometry: incidence cosine on the half-vector facet
    and the facet tilt cosine."""
    h = wi + wo
    hn = jnp.linalg.norm(h, axis=-1, keepdims=True)
    h = h / jnp.maximum(hn, 1e-12)
    cos_gamma = jnp.clip(jnp.sum(wi * h, axis=-1), 1e-6, 1.0)
    cos_beta = jnp.clip(h[..., 2], 1e-6, 1.0)
    return cos_gamma, cos_beta


def maignan_mueller(params, wi, wo, p=None):
    """Maignan (2009) polarized BRDF: RPV scalar base (depolarizing) plus
    the one-parameter Fresnel specular peak (their Eq. 21; reference
    ``maignan`` plugin):

        M_pol = C exp(-nu NDVI) exp(-tan gamma) F(gamma, m) / (4 (mu_i + mu_o))

    with gamma the facet incidence angle and F the Fresnel reflection
    Mueller matrix. ``params['ndvi']`` carries the product nu*NDVI.
    """
    mu_i = _mu(wi)
    mu_o = _mu(wo)
    valid = (mu_i > 1e-6) & (mu_o > 1e-6)

    cos_gamma, _ = _facet_geometry(wi, wo)
    tan_gamma = jnp.sqrt(jnp.maximum(1.0 - cos_gamma**2, 0.0)) / cos_gamma

    m_re = params["refr_re"] / params["ext_ior"]
    m_im = params["refr_im"] / params["ext_ior"]
    A = (
        params["C"]
        * jnp.exp(-params["ndvi"])
        * jnp.exp(-tan_gamma)
        / jnp.maximum(4.0 * (mu_i + mu_o), 1e-9)
    )
    F = _fresnel_mueller_matrix(cos_gamma, m_re, m_im)
    peak = jnp.where(valid, A, 0.0)[..., None, None] * F
    base = depolarizer(rpv_eval(params, wi, wo, p))
    return base + peak


def maignan_eval(params, wi, wo, p=None):
    """Scalar (I-I) Maignan BRDF: RPV base + specular-peak intensity."""
    M = maignan_mueller(params, wi, wo, p)
    return M[..., 0, 0]


def _smith_lambda(mu, sigma2):
    """Smith shadowing auxiliary Lambda(mu) for an isotropic Gaussian slope
    distribution with total mean-square slope ``sigma2``."""
    mu = jnp.clip(mu, 1e-6, 1.0)
    cot = mu / jnp.sqrt(jnp.maximum(1.0 - mu * mu, 1e-12))
    v = cot / jnp.sqrt(2.0 * jnp.maximum(sigma2, 1e-9))
    return 0.5 * (jnp.exp(-v * v) / (v * jnp.sqrt(jnp.pi)) - erfc(v))


def ocean_mishchenko_mueller(params, wi, wo, p=None):
    """Mishchenko & Travis (1997) polarized sunglint: Cox-Munk Gaussian
    facet distribution x Fresnel reflection Mueller matrix x bistatic Smith
    shadowing (reference ``ocean_mishchenko`` plugin; opaque surface,
    glint only)."""
    mu_i = _mu(wi)
    mu_o = _mu(wo)
    valid = (mu_i > 1e-6) & (mu_o > 1e-6)
    mu_i = jnp.maximum(mu_i, 1e-6)
    mu_o = jnp.maximum(mu_o, 1e-6)

    cos_gamma, cos_beta = _facet_geometry(wi, wo)

    # Cox & Munk (1954) isotropic mean-square slope
    sigma2 = 0.003 + 0.00512 * params["wind_speed"]
    tan2_beta = (1.0 - cos_beta**2) / cos_beta**2
    p_slope = jnp.exp(-tan2_beta / sigma2) / (jnp.pi * sigma2)

    prefactor = p_slope / (4.0 * mu_i * mu_o * cos_beta**4)

    shadow = 1.0 / (
        1.0
        + params["shadowing"]
        * (_smith_lambda(mu_i, sigma2) + _smith_lambda(mu_o, sigma2))
    )

    m_re = params["eta"] / params["ext_ior"]
    m_im = params["k"] / params["ext_ior"]
    F = _fresnel_mueller_matrix(cos_gamma, m_re, m_im)
    amp = jnp.where(valid, prefactor * shadow, 0.0)
    return amp[..., None, None] * F


def ocean_mishchenko_eval(params, wi, wo, p=None):
    """Scalar (I-I) Mishchenko glint BRDF."""
    return ocean_mishchenko_mueller(params, wi, wo, p)[..., 0, 0]


def surface_mueller(kind, params, wi, wo, p=None):
    """Mueller BRDF matrix [..., 4, 4] in plane-of-incidence frames.

    Polarized kinds get their full matrices; every other kind is an ideal
    depolarizer scaled by its scalar BRDF (exactly equivalent to the
    scalar path for unpolarized inputs).
    """
    if kind == "maignan":
        return maignan_mueller(params, wi, wo, p)
    if kind == "ocean_mishchenko":
        return ocean_mishchenko_mueller(params, wi, wo, p)
    return depolarizer(bsdf_eval(kind, params, wi, wo, p))
