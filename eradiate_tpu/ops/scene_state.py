"""Compiled scene state: the pytree the device engine consumes.

Design (SURVEY §7.1 "scene IR"): the declarative scene-element
tree (``eradiate_tpu.scenes``) compiles to a flat **pytree of arrays** plus a
hashable **static config** — not an object tree like the reference's Mitsuba
scene (``kernel/_render.py:186-209``). Re-rendering with new spectral data
is a plain function call with new pytree leaves; there is no mutable
parameter table (the functional equivalent of ``mi.traverse``/
``SceneParameters.update``, ``kernel/_render.py:212-371``).

Array shape conventions: ``S`` = spectral batch axis (wavelengths or
(bin, g) pairs), ``L`` = atmosphere layers, ``C`` = phase components,
``N`` = sensor directions/pixels. All lengths in km, sigma in km^-1.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import numpy as np

__all__ = [
    "MediumArrays",
    "SurfaceArrays",
    "IlluminationArrays",
    "SensorArrays",
    "SceneArrays",
    "SceneConfig",
]


def _pytree_dataclass(cls):
    """Register a dataclass as a JAX pytree (all fields are children)."""
    cls = dataclasses.dataclass(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


@_pytree_dataclass
class MediumArrays:
    """Layered 1D medium, spectrally batched.

    ``tau_levels[s, i]`` is the cumulative *vertical* optical depth from the
    bottom boundary up to level ``i`` — the closed-form equivalent of the
    reference's ``piecewise`` medium (SURVEY §2.1): transmittance along any
    straight ray is ``exp(-|dtau|/|mu|)`` with no tracking loop.
    """

    z_levels: Any  # [L+1]
    tau_levels: Any  # [S, L+1]
    albedo: Any  # [S, L]
    phase_weights: Any  # [S, C, L] normalized over C
    phase_params: Any  # tuple of per-component param pytrees (rows: [S, ...])


@_pytree_dataclass
class SurfaceArrays:
    """Surface BSDF parameters, spectrally batched: dict name -> [S] array
    (or [S, ...] for tabulated data)."""

    params: Any


@_pytree_dataclass
class IlluminationArrays:
    """Directional illumination.

    ``direction``: propagation direction of sunlight (unit, pointing *down*
    into the scene). ``irradiance``: [S] spectral irradiance on a plane
    perpendicular to the beam [W/m^2/nm]. ``cos_cutoff``: cosine of the
    angular radius for finite-size astro objects (1.0 = ideal directional).
    ``sky_radiance``: [S] uniform environment radiance [W/m^2/sr/nm]
    collected by escaping paths (reference ``constant`` emitter,
    ``scenes/illumination/_constant.py:35``); 0 for pure sun scenes.
    """

    direction: Any  # [3]
    irradiance: Any  # [S]
    cos_cutoff: Any  # scalar
    sky_radiance: Any = 0.0  # [S]
    #: point-source position [3] (spot emitter; None for directional).
    #: For spot, ``direction`` is the beam axis, ``irradiance`` carries the
    #: intensity [W/sr/nm] and ``cos_cutoff`` the beam half-angle cosine.
    position: Any = None


@_pytree_dataclass
class SensorArrays:
    """Distant sensor bank: one pixel per direction.

    ``directions``: [N, 3] unit vectors pointing from the scene *toward the
    sensor* (i.e. outgoing/viewing directions, z > 0 for TOA sensors).
    ``ray_offset``: altitude offset [km] below TOA for in-atmosphere
    placement (mirror of mdistant's ``ray_offset``,
    ``scenes/measure/_distant.py:334-361``); NaN = at TOA.
    ``target``: [3] target point, or [N, 3] per-pixel target points
    (``mpdistant``: each film pixel images one subcell of the target
    rectangle). Plane-parallel scenes are x,y-invariant unless the surface
    is textured or a canopy is present.
    ``target_extent``: optional [2] (or [N, 2]) full x,y extents of a jitter
    rectangle centered on ``target`` — ray origins are sampled uniformly
    over it per path, the equivalent of the reference's rectangle
    target sampling (``scenes/measure/_distant.py:139-228``).
    """

    directions: Any  # [N, 3]
    target: Any  # [3] or [N, 3]
    ray_offset: Any  # scalar
    target_extent: Any = None  # [2] or [N, 2], km


@_pytree_dataclass
class SceneArrays:
    medium: MediumArrays
    surface: SurfaceArrays
    illumination: IlluminationArrays


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    """Static (hashable) scene compilation config — part of the jit cache
    key."""

    geometry: str = "plane_parallel"  # | "spherical_shell"
    surface_kind: str = "lambertian"
    phase_kinds: tuple = ("rayleigh",)
    polarized: bool = False
    max_depth: int = 32
    rr_depth: int = 5
    #: planet radius [km] for spherical-shell geometry
    planet_radius: float = 6378.1
    #: bottom altitude of the surface [km]
    ground_altitude: float = 0.0
    #: top-of-atmosphere altitude [km]
    toa_altitude: float = 120.0
    #: whether a surface exists (False -> rays exiting at the bottom die)
    has_surface: bool = True
    #: likelihood-ratio free flight: detach the sampling geometry and
    #: carry smooth medium-ratio weights, making forward-mode derivatives
    #: w.r.t. extinction parameters unbiased (eradiate_tpu.sensitivity).
    #: Primal output is BIT-IDENTICAL either way; the flag only controls
    #: whether the extra tangent plumbing (one fetch column + a tau(z)
    #: interpolation per bounce, ~7% on c1-class scenes) is built.
    lr_flight: bool = False
    #: whether the sensor measures at TOA looking down (True) or is placed
    #: inside the medium via ray_offset
    sensor_at_toa: bool = True
    #: sample generator for the primary dimension (first collision
    #: distance): independent | stratified | multijitter | orthogonal |
    #: ldsampler (reference sampler plugins, ``_core.py:142-154``)
    sampler: str = "independent"
    #: emitter family: "directional" (sun/astroobject/constant) or "spot"
    #: (point source with conical beam; canopy tracer only)
    illumination_kind: str = "directional"
    #: per-bounce uniform expansion: "pcg4d" (integer hash,
    #: default) | "threefry" (legacy bit stream). Key
    #: *derivation* is threefry either way — see ops/fastrng.py.
    rng: str = "pcg4d"
