"""Surface BSDF evaluation and sampling (pure JAX, path-batched).

JAX equivalents of the reference's C++ BSDF plugins (SURVEY §2.1:
``diffuse``/lambertian, ``rpv``, ``hapke``, ``rtls``, ``bilambertian``,
ocean family, ...). Formulas are re-derived from the published models, not
ported from Mitsuba.

Conventions
-----------
``wi`` and ``wo`` are unit vectors pointing *away from the surface point*
(+z up): ``wi`` toward the light, ``wo`` toward the viewer. ``eval``
returns the BRDF value f [1/sr] such that dL_o = f * cos(theta_i) * dE_i.
``sample`` draws a continuation direction for backward tracing and returns
``(w_new, weight)`` with ``weight = f * cos / pdf``.

Parameters are per-spectral-index scalars (the tracer vmaps over the
spectral axis); positional texture lookups receive the surface hit point.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.warp import square_to_cosine_hemisphere

__all__ = ["bsdf_eval", "bsdf_sample", "SUPPORTED_BSDFS"]


def _mu(w):
    return jnp.maximum(w[..., 2], 0.0)


# ---------------------------------------------------------------------------
# Lambertian (reference kernel plugin `diffuse`, `scenes/bsdfs/_lambertian.py:44`)
# ---------------------------------------------------------------------------


def lambertian_eval(params, wi, wo, p=None):
    rho = params["reflectance"]
    return jnp.where(
        (_mu(wi) > 0) & (_mu(wo) > 0), rho / jnp.pi, 0.0
    )


# ---------------------------------------------------------------------------
# RPV (reference kernel plugin `rpv`, `scenes/bsdfs/_rpv.py:15-110`)
# Rahman, Pinty & Verstraete (1993); hot spot at wi == wo.
# ---------------------------------------------------------------------------


def rpv_eval(params, wi, wo, p=None):
    rho_0 = params["rho_0"]
    k = params["k"]
    g = params["g"]
    rho_c = params.get("rho_c", rho_0)

    mu_i = _mu(wi)
    mu_o = _mu(wo)
    valid = (mu_i > 1e-7) & (mu_o > 1e-7)
    mu_i = jnp.maximum(mu_i, 1e-7)
    mu_o = jnp.maximum(mu_o, 1e-7)

    # Minnaert-like bowl term
    M = (mu_i * mu_o * (mu_i + mu_o)) ** (k - 1.0)

    # Henyey-Greenstein term on the hot-spot-aligned angle:
    # cos(Theta) = wi . wo (= +1 at exact backscattering)
    cos_T = jnp.sum(wi * wo, axis=-1)
    F = (1.0 - g * g) / jnp.maximum(
        (1.0 + g * g + 2.0 * g * cos_T) ** 1.5, 1e-12
    )

    # Hot-spot factor: G = sqrt(tan^2 i + tan^2 o - 2 tan i tan o cos dphi)
    ti = jnp.sqrt(jnp.maximum(1.0 - mu_i * mu_i, 0.0)) / mu_i
    to = jnp.sqrt(jnp.maximum(1.0 - mu_o * mu_o, 0.0)) / mu_o
    # cos of azimuth difference between wi and wo
    sin_i = jnp.sqrt(jnp.maximum(1.0 - mu_i * mu_i, 1e-30))
    sin_o = jnp.sqrt(jnp.maximum(1.0 - mu_o * mu_o, 1e-30))
    cos_dphi = (cos_T - mu_i * mu_o) / (sin_i * sin_o)
    cos_dphi = jnp.clip(cos_dphi, -1.0, 1.0)
    G = jnp.sqrt(jnp.maximum(ti * ti + to * to - 2.0 * ti * to * cos_dphi, 0.0))
    H = 1.0 + (1.0 - rho_c) / (1.0 + G)

    # Rahman's rho is a BRF; BRDF = BRF / pi
    return jnp.where(valid, rho_0 * M * F * H / jnp.pi, 0.0)


# ---------------------------------------------------------------------------
# Black (absorber), `scenes/bsdfs/_black.py`
# ---------------------------------------------------------------------------


def black_eval(params, wi, wo, p=None):
    return jnp.zeros(jnp.broadcast_shapes(wi[..., 0].shape, wo[..., 0].shape))


# ---------------------------------------------------------------------------
# Checkerboard (two-reflectance lambertian texture),
# `scenes/bsdfs/_checkerboard.py:71`
# ---------------------------------------------------------------------------


def checkerboard_eval(params, wi, wo, p=None):
    rho_a = params["reflectance_a"]
    rho_b = params["reflectance_b"]
    scale = params.get("scale_pattern", 2.0)
    extent = params.get("extent", 1.0)
    if p is None:
        rho = rho_a
    else:
        # uv in [0,1) over the surface extent, Mitsuba checkerboard parity
        u = (p[..., 0] / extent + 0.5) * scale
        v = (p[..., 1] / extent + 0.5) * scale
        parity = (jnp.floor(u) + jnp.floor(v)) % 2.0
        rho = jnp.where(parity < 1.0, rho_a, rho_b)
    return jnp.where((_mu(wi) > 0) & (_mu(wo) > 0), rho / jnp.pi, 0.0)


# ---------------------------------------------------------------------------
# Hapke (reference kernel plugin `hapke`, `scenes/bsdfs/_hapke.py:141`)
# Hapke (2012) IMSA with shadow-hiding opposition effect and macroscopic
# roughness (Hapke 1984); parameters w, b, c, theta [rad], B_0, h.
# ---------------------------------------------------------------------------


def _hapke_phase(b, c, cos_g):
    """Double Henyey-Greenstein on the phase angle g (cos_g = cos of the
    phase angle; g = 0 is exact backscattering). ``c`` weights the
    backscattering lobe."""
    b2 = b * b
    fwd = (1.0 - b2) / jnp.maximum(1.0 + 2.0 * b * cos_g + b2, 1e-12) ** 1.5
    bwd = (1.0 - b2) / jnp.maximum(1.0 - 2.0 * b * cos_g + b2, 1e-12) ** 1.5
    return (1.0 - c) * fwd + c * bwd


def _hapke_H(w, x):
    """Chandrasekhar H-function, Hapke (2002) approximation."""
    gamma = jnp.sqrt(jnp.maximum(1.0 - w, 1e-12))
    r0 = (1.0 - gamma) / (1.0 + gamma)
    x = jnp.maximum(x, 1e-6)
    ln_term = jnp.log((1.0 + x) / x)
    return 1.0 / (1.0 - w * x * (r0 + 0.5 * (1.0 - 2.0 * r0 * x) * ln_term))


def _hapke_roughness(theta, mu_i, mu_o, cos_phi, sin_phi):
    """Hapke (1984) macroscopic roughness correction.

    Returns (mu0_e, mu_e, S): effective cosines and the shadowing factor.
    ``cos_phi``/``sin_phi``: azimuth difference between the incidence and
    emergence projections.
    """
    theta = jnp.maximum(theta, 1e-4)
    tan_t = jnp.tan(theta)
    cot_t = 1.0 / tan_t
    # chi(theta)
    chi = 1.0 / jnp.sqrt(1.0 + jnp.pi * tan_t * tan_t)

    sin_i = jnp.sqrt(jnp.maximum(1.0 - mu_i * mu_i, 1e-12))
    sin_o = jnp.sqrt(jnp.maximum(1.0 - mu_o * mu_o, 1e-12))
    tan_i = sin_i / mu_i
    tan_o = sin_o / mu_o
    cot_i = 1.0 / jnp.maximum(tan_i, 1e-6)
    cot_o = 1.0 / jnp.maximum(tan_o, 1e-6)

    def E1(cot_x):
        return jnp.exp(-2.0 / jnp.pi * cot_t * cot_x)

    def E2(cot_x):
        return jnp.exp(-1.0 / jnp.pi * cot_t * cot_t * cot_x * cot_x)

    phi = jnp.arctan2(sin_phi, cos_phi)
    phi = jnp.abs(phi)  # symmetric
    # tan(phi/2) overflows (and can flip sign in f32) at phi ~ pi; the
    # correction factor is 0 there, so clamp the half-angle below pi/2.
    half_phi = jnp.minimum(phi / 2.0, jnp.pi / 2.0 - 1e-4)
    f_psi = jnp.exp(-2.0 * jnp.tan(half_phi))

    # eta functions
    def eta(mu_x, sin_x, cot_x):
        return chi * (mu_x + sin_x * tan_t * E2(cot_x) / jnp.maximum(2.0 - E1(cot_x), 1e-12))

    eta_i = eta(mu_i, sin_i, cot_i)
    eta_o = eta(mu_o, sin_o, cot_o)

    # i <= e and i > e branches (Hapke 1984 eqs. 46-51), selected branchless
    sin_hp2 = jnp.sin(phi / 2.0) ** 2
    denom_ie = 2.0 - E1(cot_o) - (phi / jnp.pi) * E1(cot_i)
    denom_ei = 2.0 - E1(cot_i) - (phi / jnp.pi) * E1(cot_o)

    # case i <= e (emergence more oblique)
    mu0e_1 = chi * (
        mu_i
        + sin_i
        * tan_t
        * (jnp.cos(phi) * E2(cot_o) + sin_hp2 * E2(cot_i))
        / jnp.maximum(denom_ie, 1e-12)
    )
    mue_1 = chi * (
        mu_o
        + sin_o
        * tan_t
        * (E2(cot_o) - sin_hp2 * E2(cot_i))
        / jnp.maximum(denom_ie, 1e-12)
    )
    # case i > e
    mu0e_2 = chi * (
        mu_i
        + sin_i
        * tan_t
        * (E2(cot_i) - sin_hp2 * E2(cot_o))
        / jnp.maximum(denom_ei, 1e-12)
    )
    mue_2 = chi * (
        mu_o
        + sin_o
        * tan_t
        * (jnp.cos(phi) * E2(cot_i) + sin_hp2 * E2(cot_o))
        / jnp.maximum(denom_ei, 1e-12)
    )

    i_le_e = tan_i <= tan_o
    mu0e = jnp.where(i_le_e, mu0e_1, mu0e_2)
    mue = jnp.where(i_le_e, mue_1, mue_2)

    S_1 = (mue / eta_o) * (mu_i / eta_i) * chi / (1.0 - f_psi + f_psi * chi * (mu_i / eta_i))
    S_2 = (mue / eta_o) * (mu_i / eta_i) * chi / (1.0 - f_psi + f_psi * chi * (mu_o / eta_o))
    S = jnp.where(i_le_e, S_1, S_2)
    return mu0e, mue, S


def hapke_eval(params, wi, wo, p=None):
    w = params["w"]
    b = params["b"]
    c = params["c"]
    theta = params["theta"]
    B_0 = params["B_0"]
    h = params["h"]

    mu_i = _mu(wi)
    mu_o = _mu(wo)
    valid = (mu_i > 1e-6) & (mu_o > 1e-6)
    mu_i = jnp.maximum(mu_i, 1e-6)
    mu_o = jnp.maximum(mu_o, 1e-6)

    # phase angle g: cos g = wi . wo (0 at exact backscatter)
    cos_g = jnp.clip(jnp.sum(wi * wo, axis=-1), -1.0, 1.0)
    half_tan_g = jnp.sqrt(jnp.maximum((1.0 - cos_g) / (1.0 + cos_g), 0.0))

    # azimuth difference of the horizontal projections
    sin_i = jnp.sqrt(jnp.maximum(1.0 - mu_i * mu_i, 1e-12))
    sin_o = jnp.sqrt(jnp.maximum(1.0 - mu_o * mu_o, 1e-12))
    cos_phi = jnp.clip((cos_g - mu_i * mu_o) / (sin_i * sin_o), -1.0, 1.0)
    sin_phi = jnp.sqrt(jnp.maximum(1.0 - cos_phi * cos_phi, 0.0))

    P = _hapke_phase(b, c, cos_g)
    B_sh = jnp.where(h > 0, B_0 / (1.0 + half_tan_g / jnp.maximum(h, 1e-9)), 0.0)

    mu0e, mue, S = _hapke_roughness(theta, mu_i, mu_o, cos_phi, sin_phi)

    H_i = _hapke_H(w, mu0e)
    H_o = _hapke_H(w, mue)

    f = (
        (w / (4.0 * jnp.pi))
        * (1.0 / jnp.maximum(mu0e + mue, 1e-9))
        * (P * (1.0 + B_sh) + H_i * H_o - 1.0)
        * S
        * (mu0e / mu_i)  # effective-cosine flux correction
    )
    return jnp.where(valid, jnp.maximum(f, 0.0), 0.0)


# ---------------------------------------------------------------------------
# RTLS — Ross-Thick Li-Sparse-Reciprocal kernel BRDF (reference `rtls`
# plugin, `scenes/bsdfs/_rtls.py`); MODIS BRDF/albedo kernel definitions
# (Lucht, Schaaf & Strahler 2000), h/b = 2, b/r = 1.
# ---------------------------------------------------------------------------


def _rtls_kernels(mu_i, mu_o, cos_phi):
    sin_i = jnp.sqrt(jnp.maximum(1.0 - mu_i * mu_i, 0.0))
    sin_o = jnp.sqrt(jnp.maximum(1.0 - mu_o * mu_o, 0.0))
    cos_xi = jnp.clip(mu_i * mu_o + sin_i * sin_o * cos_phi, -1.0, 1.0)
    xi = jnp.arccos(cos_xi)

    # RossThick volumetric kernel
    k_vol = (
        ((jnp.pi / 2.0 - xi) * cos_xi + jnp.sin(xi))
        / jnp.maximum(mu_i + mu_o, 1e-9)
        - jnp.pi / 4.0
    )

    # LiSparse-Reciprocal geometric kernel (b/r = 1 -> primed angles equal)
    tan_i = sin_i / jnp.maximum(mu_i, 1e-9)
    tan_o = sin_o / jnp.maximum(mu_o, 1e-9)
    sec_i = 1.0 / jnp.maximum(mu_i, 1e-9)
    sec_o = 1.0 / jnp.maximum(mu_o, 1e-9)
    sin_phi = jnp.sqrt(jnp.maximum(1.0 - cos_phi * cos_phi, 0.0))
    D2 = tan_i**2 + tan_o**2 - 2.0 * tan_i * tan_o * cos_phi
    cos_t = jnp.clip(
        2.0  # h/b = 2
        * jnp.sqrt(jnp.maximum(D2 + (tan_i * tan_o * sin_phi) ** 2, 0.0))
        / jnp.maximum(sec_i + sec_o, 1e-9),
        -1.0,
        1.0,
    )
    t = jnp.arccos(cos_t)
    O = (1.0 / jnp.pi) * (t - jnp.sin(t) * cos_t) * (sec_i + sec_o)
    k_geo = O - sec_i - sec_o + 0.5 * (1.0 + cos_xi) * sec_i * sec_o
    return k_vol, k_geo


def rtls_eval(params, wi, wo, p=None):
    mu_i = _mu(wi)
    mu_o = _mu(wo)
    valid = (mu_i > 1e-6) & (mu_o > 1e-6)
    mu_i = jnp.maximum(mu_i, 1e-6)
    mu_o = jnp.maximum(mu_o, 1e-6)
    cos_g = jnp.clip(jnp.sum(wi * wo, axis=-1), -1.0, 1.0)
    sin_i = jnp.sqrt(jnp.maximum(1.0 - mu_i * mu_i, 1e-12))
    sin_o = jnp.sqrt(jnp.maximum(1.0 - mu_o * mu_o, 1e-12))
    cos_phi = jnp.clip((cos_g - mu_i * mu_o) / (sin_i * sin_o), -1.0, 1.0)
    k_vol, k_geo = _rtls_kernels(mu_i, mu_o, cos_phi)
    brf = params["f_iso"] + params["f_vol"] * k_vol + params["f_geo"] * k_geo
    return jnp.where(valid, jnp.maximum(brf, 0.0) / jnp.pi, 0.0)


# ---------------------------------------------------------------------------
# Bi-lambertian (leaf optics; reference `bilambertian` plugin)
# ---------------------------------------------------------------------------


def bilambertian_eval(params, wi, wo, p=None):
    """Two-sided diffuse: reflectance when wi, wo are on the same side of
    the surface, transmittance when on opposite sides (cosines absolute)."""
    rho = params["reflectance"]
    tau = params["transmittance"]
    same_side = (wi[..., 2] * wo[..., 2]) > 0
    return jnp.where(same_side, rho, tau) / jnp.pi


# ---------------------------------------------------------------------------
# Ocean (6SV-style; reference `ocean_legacy` plugin,
# `scenes/bsdfs/_ocean_legacy.py:100`): Cox-Munk sun glint + whitecaps +
# water-leaving underlight. Spectral optical "constants" use compact
# analytic fits (documented surrogates for the 6SV tables).
# ---------------------------------------------------------------------------


def _fresnel_unpolarized(cos_i, n):
    """Unpolarized Fresnel reflectance at an air/water interface."""
    cos_i = jnp.clip(cos_i, 1e-6, 1.0)
    sin_t2 = jnp.clip((1.0 - cos_i * cos_i) / (n * n), 0.0, 1.0)
    cos_t = jnp.sqrt(1.0 - sin_t2)
    rs = (cos_i - n * cos_t) / (cos_i + n * cos_t)
    rp = (n * cos_i - cos_t) / (n * cos_i + cos_t)
    return 0.5 * (rs * rs + rp * rp)


def _water_ior(w_nm, chlorinity):
    """ANALYTIC FALLBACK water refractive index (flat-dispersion fit +
    Friedman 1969 salinity adjustment) — production params carry the
    Hale & Querry table value (``physics.ocean_data.water_ior``) under
    the ``n_water`` key; this fit only serves params built without it."""
    n = 1.325 + 6.0 / (w_nm * 1e-2)  # gentle UV rise, ~1.334 at 550 nm
    return n + 0.00017 * chlorinity


def _whitecap_fraction(wind_speed):
    """Whitecap coverage, Monahan & O'Muircheartaigh (1980):
    2.95e-6 W^3.52."""
    return jnp.clip(2.95e-6 * jnp.maximum(wind_speed, 0.0) ** 3.52, 0.0, 1.0)


def _water_leaving_reflectance(w_nm, pigmentation):
    """ANALYTIC FALLBACK water-leaving reflectance — production params
    carry the table-driven Morel case-1 value
    (``physics.ocean_data.case1_water_reflectance``) under ``r_water``;
    this shape only serves params built without it."""
    chl = jnp.maximum(pigmentation, 1e-3)
    blue = 0.03 * jnp.exp(-0.5 * ((w_nm - 440.0) / 60.0) ** 2) * chl ** (-0.3)
    green = 0.015 * jnp.exp(-0.5 * ((w_nm - 560.0) / 50.0) ** 2) * chl**0.1
    red_cut = 1.0 / (1.0 + jnp.exp((w_nm - 700.0) / 25.0))
    return (blue + green) * red_cut


def ocean_legacy_eval(params, wi, wo, p=None):
    wind_speed = params["wind_speed"]
    chlorinity = params["chlorinity"]
    pigment = params["pigmentation"]
    w_nm = params["wavelength"]

    mu_i = _mu(wi)
    mu_o = _mu(wo)
    valid = (mu_i > 1e-6) & (mu_o > 1e-6)
    mu_i = jnp.maximum(mu_i, 1e-6)
    mu_o = jnp.maximum(mu_o, 1e-6)

    # half vector = specular facet normal
    h = wi + wo
    hn = jnp.linalg.norm(h, axis=-1, keepdims=True)
    h = h / jnp.maximum(hn, 1e-12)
    cos_beta = jnp.clip(h[..., 2], 1e-6, 1.0)  # facet tilt
    cos_theta_h = jnp.clip(jnp.sum(wi * h, axis=-1), 1e-6, 1.0)

    # Cox & Munk (1954) isotropic slope distribution
    sigma2 = 0.003 + 0.00512 * wind_speed
    tan2_beta = (1.0 - cos_beta**2) / cos_beta**2
    p_slope = jnp.exp(-tan2_beta / sigma2) / (jnp.pi * sigma2)

    # table-driven optical constants when the params carry them (the
    # product path: scenes.bsdfs.OceanLegacyBSDF.eval_params evaluates
    # the Hale & Querry / Morel case-1 tables host-side); analytic
    # fallbacks otherwise
    n_w = params.get("n_water", _water_ior(w_nm, chlorinity))
    R_F = _fresnel_unpolarized(cos_theta_h, n_w)

    f_glint = p_slope * R_F / (4.0 * mu_i * mu_o * cos_beta**4)

    # whitecaps: lambertian, albedo 0.22 dropping in the NIR (Koepke 1984)
    F_wc = _whitecap_fraction(wind_speed)
    a_wc = 0.22 * jnp.clip(1.0 - (w_nm - 900.0) / 2200.0, 0.2, 1.0)
    f_wc = a_wc / jnp.pi

    # water-leaving: lambertian underlight transmitted through the surface
    R_w = params.get("r_water", _water_leaving_reflectance(w_nm, pigment))
    t_up = 1.0 - _fresnel_unpolarized(mu_o, n_w)
    t_down = 1.0 - _fresnel_unpolarized(mu_i, n_w)
    f_water = R_w * t_up * t_down / jnp.pi

    f = F_wc * f_wc + (1.0 - F_wc) * (f_glint + f_water)
    return jnp.where(valid, f, 0.0)


def ocean_grasp_eval(params, wi, wo, p=None):
    """GRASP-convention ocean BRDF (reference `ocean_grasp`,
    `scenes/bsdfs/_ocean_grasp.py`): Cox-Munk glint with a user-supplied
    water IOR spectrum ``eta`` plus a lambertian water-body reflectance
    term ``water_body_reflectance`` transmitted through the interface,
    mixed with wind-driven whitecaps. Same structure as the legacy 6SV
    surface but parametrized directly by (wind_speed, eta, R_wb) as in the
    3DREAMS GRASP scenarios (``test_tools/test_cases/ocean.py:36-185``)."""
    wind_speed = params["wind_speed"]
    n_w = params["eta"]
    R_wb = params["water_body_reflectance"]

    mu_i = _mu(wi)
    mu_o = _mu(wo)
    valid = (mu_i > 1e-6) & (mu_o > 1e-6)
    mu_i = jnp.maximum(mu_i, 1e-6)
    mu_o = jnp.maximum(mu_o, 1e-6)

    h = wi + wo
    hn = jnp.linalg.norm(h, axis=-1, keepdims=True)
    h = h / jnp.maximum(hn, 1e-12)
    cos_beta = jnp.clip(h[..., 2], 1e-6, 1.0)
    cos_theta_h = jnp.clip(jnp.sum(wi * h, axis=-1), 1e-6, 1.0)

    sigma2 = 0.003 + 0.00512 * wind_speed
    tan2_beta = (1.0 - cos_beta**2) / cos_beta**2
    p_slope = jnp.exp(-tan2_beta / sigma2) / (jnp.pi * sigma2)
    R_F = _fresnel_unpolarized(cos_theta_h, n_w)
    f_glint = p_slope * R_F / (4.0 * mu_i * mu_o * cos_beta**4)

    F_wc = _whitecap_fraction(wind_speed)
    f_wc = 0.22 / jnp.pi

    t_up = 1.0 - _fresnel_unpolarized(mu_o, n_w)
    t_down = 1.0 - _fresnel_unpolarized(mu_i, n_w)
    f_wb = R_wb * t_up * t_down / jnp.pi

    f = F_wc * f_wc + (1.0 - F_wc) * (f_glint + f_wb)
    return jnp.where(valid, f, 0.0)


# ---------------------------------------------------------------------------
# Measured quasi-diffuse BRDF (reference `mqdiffuse`,
# `scenes/bsdfs/_mqdiffuse.py:127`): gridded data over
# (theta_o, phi_d, theta_i), trilinear interpolation.
# ---------------------------------------------------------------------------


def mqdiffuse_eval(params, wi, wo, p=None):
    data = params["data"]  # [Nto, Npd, Nti]
    cos_i = _mu(wi)
    cos_o = _mu(wo)
    valid = (cos_i > 1e-6) & (cos_o > 1e-6)
    theta_i = jnp.arccos(jnp.clip(cos_i, 0.0, 1.0))
    theta_o = jnp.arccos(jnp.clip(cos_o, 0.0, 1.0))
    phi_d = jnp.abs(
        jnp.arctan2(wo[..., 1], wo[..., 0]) - jnp.arctan2(wi[..., 1], wi[..., 0])
    ) % (2.0 * jnp.pi)
    phi_d = jnp.where(phi_d > jnp.pi, 2.0 * jnp.pi - phi_d, phi_d)

    nto, npd, nti = data.shape

    def idx(x, xmax, npts):
        u = jnp.clip(x / xmax, 0.0, 1.0) * (npts - 1)
        i0 = jnp.clip(jnp.floor(u).astype(jnp.int32), 0, npts - 2)
        return i0, u - i0

    io, fo = idx(theta_o, jnp.pi / 2, nto)
    ip, fp = idx(phi_d, jnp.pi, npd)
    ii, fi = idx(theta_i, jnp.pi / 2, nti)

    def g(a, b, c):
        return data[a, b, c]

    val = 0.0
    for da, wa in ((0, 1 - fo), (1, fo)):
        for db, wb in ((0, 1 - fp), (1, fp)):
            for dc, wc in ((0, 1 - fi), (1, fi)):
                val = val + wa * wb * wc * g(io + da, ip + db, ii + dc)
    return jnp.where(valid, val, 0.0)


# ---------------------------------------------------------------------------
# Bitmap texture (reference stock `bitmap` texture under a `diffuse` BSDF,
# `scenes/bsdfs/_lambertian.py` + Mitsuba bitmap plugin): spatially varying
# lambertian reflectance from a gridded map.
# ---------------------------------------------------------------------------


def _bilinear_wrap(data, u, v):
    """Bilinear lookup of ``data`` [H, W] at uv in [0, 1) with repeat
    wrapping (Mitsuba bitmap texture defaults: wrap repeat + bilinear)."""
    h, w = data.shape
    u = (u % 1.0) * w - 0.5
    v = (v % 1.0) * h - 0.5
    i0 = jnp.floor(u).astype(jnp.int32)
    j0 = jnp.floor(v).astype(jnp.int32)
    fu = u - i0
    fv = v - j0
    i0w, i1w = i0 % w, (i0 + 1) % w
    j0w, j1w = j0 % h, (j0 + 1) % h
    return (
        data[j0w, i0w] * (1 - fu) * (1 - fv)
        + data[j0w, i1w] * fu * (1 - fv)
        + data[j1w, i0w] * (1 - fu) * fv
        + data[j1w, i1w] * fu * fv
    )


def _uv_from_p(p, extent):
    """Surface point -> texture uv: the map spans [-extent/2, extent/2]^2."""
    u = p[..., 0] / extent + 0.5
    v = p[..., 1] / extent + 0.5
    return u, v


def bitmap_eval(params, wi, wo, p=None):
    data = params["data"]  # [H, W] reflectance map (per spectral row)
    if p is None:
        rho = jnp.mean(data)
    else:
        u, v = _uv_from_p(p, params["extent"])
        rho = _bilinear_wrap(data, u, v)
    return jnp.where((_mu(wi) > 0) & (_mu(wo) > 0), rho / jnp.pi, 0.0)


# ---------------------------------------------------------------------------
# Composite BSDFs: static structure lives in the ':'-separated kind string
# (part of the jit cache key); per-child parameters are prefix-namespaced in
# the params dict. Engine equivalents of the reference's `mask`/opacity-mask
# (`scenes/bsdfs/_opacity_mask.py:88`), `selectbsdf` (expert plugin, release
# notes v0.29.x) and the CentralPatchSurface dual-BSDF composite
# (`scenes/surface/_central_patch.py:37`).
# ---------------------------------------------------------------------------


def _sub(params, prefix):
    n = len(prefix)
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix)}


def _composite_eval(kind, params, wi, wo, p=None):
    parts = kind.split(":")
    head = parts[0]
    if head == "central_patch":
        bg_kind, patch_kind = parts[1], parts[2]
        f_bg = bsdf_eval(bg_kind, _sub(params, "bg_"), wi, wo, p)
        f_patch = bsdf_eval(patch_kind, _sub(params, "patch_"), wi, wo, p)
        if p is None:
            return f_bg
        edge = params["patch_edges"]  # half-extent [km]
        inside = (jnp.abs(p[..., 0]) <= edge) & (jnp.abs(p[..., 1]) <= edge)
        return jnp.where(inside, f_patch, f_bg)
    if head == "opacity_mask":
        f = bsdf_eval(parts[1], _sub(params, "nested_"), wi, wo, p)
        if p is None:
            return f
        u, v = _uv_from_p(p, params["mask_extent"])
        opacity = _bilinear_wrap(params["opacity_map"], u, v)
        # opacity < 1 passes light through the surface plane (null BSDF);
        # for an opaque ground that energy is lost -> scale the reflection
        return f * jnp.clip(opacity, 0.0, 1.0)
    if head == "select":
        child_kinds = parts[1:]
        fs = [
            bsdf_eval(k, _sub(params, f"c{i}_"), wi, wo, p)
            for i, k in enumerate(child_kinds)
        ]
        stacked = jnp.stack(fs, axis=0)  # [C, ...]
        if p is None:
            return fs[0]
        data = params["index_map"]  # [H, W] float-stored integer indices
        h, w = data.shape
        u, v = _uv_from_p(p, params["select_extent"])
        i = (jnp.clip(u, 0.0, 1.0 - 1e-7) * w).astype(jnp.int32)
        j = (jnp.clip(v, 0.0, 1.0 - 1e-7) * h).astype(jnp.int32)
        idx = jnp.round(data[j, i]).astype(jnp.int32)
        idx = jnp.clip(idx, 0, len(child_kinds) - 1)
        return jnp.take_along_axis(stacked, idx[None, ...], axis=0)[0]
    raise ValueError(f"unsupported composite BSDF kind '{kind}'")


_EVAL = {
    "lambertian": lambertian_eval,
    "bitmap": bitmap_eval,
    "rpv": rpv_eval,
    "black": black_eval,
    "checkerboard": checkerboard_eval,
    "hapke": hapke_eval,
    "rtls": rtls_eval,
    "bilambertian": bilambertian_eval,
    "ocean_legacy": ocean_legacy_eval,
    "ocean_grasp": ocean_grasp_eval,
    "mqdiffuse": mqdiffuse_eval,
}


def _maignan_eval(params, wi, wo, p=None):
    from .bsdf_polarized import maignan_eval

    return maignan_eval(params, wi, wo, p)


def _ocean_mishchenko_eval(params, wi, wo, p=None):
    from .bsdf_polarized import ocean_mishchenko_eval

    return ocean_mishchenko_eval(params, wi, wo, p)


# scalar (I-I) components of the polarized surface models (full Mueller
# matrices live in ops.bsdf_polarized; lazy imports break the module cycle)
_EVAL["maignan"] = _maignan_eval
_EVAL["ocean_mishchenko"] = _ocean_mishchenko_eval

SUPPORTED_BSDFS = tuple(sorted(_EVAL))


def bsdf_eval(kind, params, wi, wo, p=None):
    """BRDF value f(wi, wo) [1/sr]; static dispatch on ``kind``.

    Composite kinds encode their structure in the string itself
    (``central_patch:<bg>:<patch>``, ``opacity_mask:<nested>``,
    ``select:<k0>:<k1>:...``) so the jit cache key captures it.
    """
    if ":" in kind:
        return _composite_eval(kind, params, wi, wo, p)
    try:
        fn = _EVAL[kind]
    except KeyError:
        raise ValueError(f"unsupported BSDF kind '{kind}'") from None
    return fn(params, wi, wo, p)


def bilambertian_sample_from_uniforms(params, wo, u_side, u):
    """Sample the two-sided diffuse BSDF in the local leaf frame (+z = the
    side ``wo`` leaves from) from pre-drawn uniforms (``u_side`` [...],
    ``u`` [..., 2]). Returns (w_new, weight): reflect with probability
    rho/(rho+tau) (cosine-weighted, +z), transmit otherwise
    (cosine-weighted, -z); weight = rho + tau."""
    rho = params["reflectance"]
    tau = params["transmittance"]
    total = rho + tau
    p_ref = rho / jnp.maximum(total, 1e-12)
    # Sample the side from the DETACHED probability and restore the
    # parameter dependence with a likelihood-ratio weight (primal exactly
    # 1: x/x == 1 in IEEE for finite nonzero x; guarded at 0). Without
    # this, a detached-JVP sensitivity over rho/tau silently drops the
    # discrete-choice boundary term (the bias class described in
    # eradiate_tpu.sensitivity); with it, rho/tau channels are exactly
    # differentiable while production output is bit-identical.
    sg = jax.lax.stop_gradient
    p_ref_d = sg(p_ref)
    reflect = u_side < p_ref_d
    ratio = jnp.where(
        reflect,
        jnp.where(p_ref_d > 0, p_ref / jnp.maximum(p_ref_d, 1e-30), 1.0),
        jnp.where(
            p_ref_d < 1.0,
            (1.0 - p_ref) / jnp.maximum(1.0 - p_ref_d, 1e-30),
            1.0,
        ),
    )
    w_new = square_to_cosine_hemisphere(u)
    w_new = jnp.where(reflect[..., None], w_new, w_new * jnp.asarray([1.0, 1.0, -1.0]))
    weight = jnp.where(total > 0, total * ratio, 0.0)
    return w_new, weight


def bilambertian_sample(params, wo, key):
    """Key-based wrapper over :func:`bilambertian_sample_from_uniforms`."""
    k_side, k_dir = jax.random.split(key)
    u_side = jax.random.uniform(k_side, wo.shape[:-1])
    u = jax.random.uniform(k_dir, wo.shape[:-1] + (2,))
    return bilambertian_sample_from_uniforms(params, wo, u_side, u)


def bsdf_sample_from_uniforms(kind, params, wo, u, p=None):
    """Sample continuation direction for backward tracing from pre-drawn
    uniforms ``u`` [..., 2] (batch-friendly, no per-path keys).

    Cosine-hemisphere importance sampling (pdf = cos/pi) with exact
    ``f cos / pdf`` weighting — optimal for lambertian, robust for the
    smooth hemispherical models (RPV/Hapke/RTLS). Specular ocean surfaces
    override this with their own strategy.

    Returns (w_new, weight).
    """
    w_new = square_to_cosine_hemisphere(u)
    if kind in ("lambertian", "checkerboard"):
        # f = rho/pi, pdf = cos/pi -> weight = rho
        f = bsdf_eval(kind, params, w_new, wo, p)
        weight = f * jnp.pi
    elif kind == "black":
        weight = jnp.zeros(wo.shape[:-1])
    else:
        f = bsdf_eval(kind, params, w_new, wo, p)
        weight = f * jnp.pi  # cos cancels against the cosine pdf
    return w_new, weight


def bsdf_sample(kind, params, wo, key, p=None):
    """Key-based wrapper over :func:`bsdf_sample_from_uniforms`."""
    u = jax.random.uniform(key, wo.shape[:-1] + (2,))
    return bsdf_sample_from_uniforms(kind, params, wo, u, p)
