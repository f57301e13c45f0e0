"""Sample generators (reference Mitsuba samplers: ``independent``,
``stratified``, ``multijitter``, ``orthogonal``, ``ldsampler``;
``scenes/measure/_core.py:142-154``).

Design: the reference's samplers are stateful per-pixel streams
(PCG32) feeding every MC decision. Here all secondary decisions come from
counter-based threefry keys (deterministic under resharding); the sampler
kind controls the **primary sample dimension** — the first collision
distance, which dominates estimator variance for distant radiometer banks.
Stratifying path-dependent dimensions beyond the first has vanishing effect
(paths diverge after one event), so this build spends its structure where
it pays: the first flight.

All generators return ``u`` in [0, 1) of shape ``[spp]`` (per pixel), to be
broadcast across pixels with per-pixel decorrelation (Cranley-Patterson
rotation by a per-pixel uniform offset).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["SAMPLER_KINDS", "primary_samples"]

SAMPLER_KINDS = (
    "independent",
    "stratified",
    "multijitter",
    "orthogonal",
    "ldsampler",
)


def _radical_inverse_base2(i):
    """Van der Corput sequence: bit-reversed integers mapped to [0, 1)."""
    i = i.astype(jnp.uint32)
    i = ((i & jnp.uint32(0x55555555)) << 1) | ((i & jnp.uint32(0xAAAAAAAA)) >> 1)
    i = ((i & jnp.uint32(0x33333333)) << 2) | ((i & jnp.uint32(0xCCCCCCCC)) >> 2)
    i = ((i & jnp.uint32(0x0F0F0F0F)) << 4) | ((i & jnp.uint32(0xF0F0F0F0)) >> 4)
    i = ((i & jnp.uint32(0x00FF00FF)) << 8) | ((i & jnp.uint32(0xFF00FF00)) >> 8)
    i = (i << 16) | (i >> 16)
    return i.astype(jnp.float32) * jnp.float32(2.3283064365386963e-10)  # 2^-32


def primary_samples(kind: str, spp: int, key):
    """Primary-dimension samples for one pixel: ``u`` [spp] in [0, 1).

    - ``independent``: iid uniforms.
    - ``stratified``: one jittered sample per stratum ``[k/spp, (k+1)/spp)``.
    - ``multijitter``: stratified with sub-stratum jitter correlation
      (Chiu-Shirley-Wang); its 1D projection is stratified with a shared
      sub-offset permutation.
    - ``orthogonal``: orthogonal-array sampling; 1D projection likewise
      stratified (strength-2 OA guarantees 1D stratification by
      construction), realized as a random-permutation stratified set.
    - ``ldsampler``: low-discrepancy van der Corput (base 2) points.

    Per-pixel decorrelation (rotation/scramble) is the caller's job — fold
    the pixel index into ``key`` before calling.
    """
    if kind == "independent":
        return jax.random.uniform(key, (spp,))
    idx = jnp.arange(spp)
    if kind == "stratified":
        jitter = jax.random.uniform(key, (spp,))
        return (idx + jitter) / spp
    if kind == "multijitter":
        # correlated multi-jitter 1D projection: stratified strata with a
        # permuted sub-stratum offset + fine jitter
        k_perm, k_jit = jax.random.split(key)
        sub = jax.random.permutation(k_perm, spp)
        jitter = jax.random.uniform(k_jit, (spp,))
        return (idx + (sub + jitter) / spp) / spp
    if kind == "orthogonal":
        # strength-2 OA 1D projection: randomly permuted stratified set
        k_perm, k_jit = jax.random.split(key)
        perm = jax.random.permutation(k_perm, spp)
        jitter = jax.random.uniform(k_jit, (spp,))
        return (perm + jitter) / spp
    if kind == "ldsampler":
        # van der Corput with a Cranley-Patterson rotation from the key
        shift = jax.random.uniform(key, ())
        return (_radical_inverse_base2(idx) + shift) % 1.0
    raise ValueError(f"unsupported sampler kind '{kind}'")


# ---------------------------------------------------------------------------
# Full-dimension padded low-discrepancy sampling (VERDICT r1, Missing #5)
#
# The structured kinds above shape only the PRIMARY dimension (first flight
# distance). The padded generator below extends structure to every MC
# decision of every bounce: dimension (depth, purpose) of sample s in a
# pixel draws the Owen-scrambled van der Corput point of index s, with an
# independent scramble per (pixel, depth, purpose). Owen scrambling
# preserves the (0,2)-sequence stratification within each dimension while
# decorrelating dimensions — the classic "padded" construction (cf. Burley,
# JCGT 2020, hash-based Owen scrambling; public-domain technique).
#
# Keys depend only on (pixel, depth, dim) and the slot is the GLOBAL
# within-pixel sample id, so sample-axis sharding preserves the exact point
# set (same invariant as the independent path's global sample-id keys).


def _laine_karras(x, seed):
    """Hash-based nested-uniform (Owen) permutation in base-2 suffix
    domain: bit k of the output depends only on bits <= k of the input."""
    x = x + seed
    x = x ^ (x * jnp.uint32(0x6C50B47C))
    x = x ^ (x * jnp.uint32(0xB82F1E52))
    x = x ^ (x * jnp.uint32(0xC7AFE638))
    x = x ^ (x * jnp.uint32(0x8D22F6E6))
    return x


def _reverse_bits32(i):
    i = ((i & jnp.uint32(0x55555555)) << 1) | ((i & jnp.uint32(0xAAAAAAAA)) >> 1)
    i = ((i & jnp.uint32(0x33333333)) << 2) | ((i & jnp.uint32(0xCCCCCCCC)) >> 2)
    i = ((i & jnp.uint32(0x0F0F0F0F)) << 4) | ((i & jnp.uint32(0xF0F0F0F0)) >> 4)
    i = ((i & jnp.uint32(0x00FF00FF)) << 8) | ((i & jnp.uint32(0xFF00FF00)) >> 8)
    return (i << 16) | (i >> 16)


def _hash32(x):
    """Finalizer-style integer hash (bias scramble seeds apart)."""
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def owen_scrambled_vdc(idx, seed):
    """Owen-shuffled, Owen-scrambled base-2 van der Corput point in [0, 1).

    The scramble alone (``reverse_bits(LK(i))``) leaves the most
    significant output digit a parity function of ``i`` + seed — across
    dimensions that yields near-perfect rank correlation (measured ~1.0).
    The cure is the canonical shuffle+scramble pair: owen-SHUFFLE the
    index in its own digit domain with one seed stream, then owen-SCRAMBLE
    the VdC value with another (cf. Burley, JCGT 2020 §10.3: padding
    decorrelates dimensions via per-dimension index shuffles).

    ``u_bits = rev(LK(rev(LK(rev(i), s_shuffle)), s_scramble))``; same-
    shaped uint32 ``idx``/``seed``.
    """
    idx = idx.astype(jnp.uint32)
    seed = seed.astype(jnp.uint32)
    s_shuffle = _hash32(seed ^ jnp.uint32(0x55AA55AA))
    s_scramble = _hash32(seed ^ jnp.uint32(0x33CC33CC))
    i2 = _reverse_bits32(_laine_karras(_reverse_bits32(idx), s_shuffle))
    x = _reverse_bits32(_laine_karras(i2, s_scramble))
    # top-24-bit conversion: a plain astype(float32) * 2^-32 rounds the
    # 128 largest bit patterns UP to exactly 1.0, violating the [0, 1)
    # contract (u_dist = 1.0 -> tau_s = -log1p(-1) = inf in the tracer)
    return (x >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(
        5.960464477539063e-08  # 2^-24
    )


def padded_bounce_uniforms(slot, pix_seed, depth_b, n_dims=10):
    """[B, n_dims] Owen-scrambled VdC points for one bounce.

    ``slot`` [B]: global within-pixel sample index; ``pix_seed`` [B]
    uint32 per-pixel scramble base; ``depth_b`` [B] current bounce depth.
    Each (pixel, depth, dim) gets an independent scramble, so every
    dimension of every bounce is a stratified-in-the-limit point set over
    a pixel's samples while dimensions stay decorrelated.
    """
    dims = jnp.arange(n_dims, dtype=jnp.uint32)
    h = _hash32(
        depth_b.astype(jnp.uint32)[:, None] * jnp.uint32(0x9E3779B9)
        + dims[None, :] * jnp.uint32(0x85EBCA6B)
    )
    seeds = _hash32(pix_seed.astype(jnp.uint32)[:, None] ^ h)
    return owen_scrambled_vdc(
        jnp.broadcast_to(slot.astype(jnp.uint32)[:, None], seeds.shape), seeds
    )
