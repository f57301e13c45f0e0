"""Counter-based RNG for the per-bounce uniform draws.

Motivation (round 5, measured on the previous accelerator): a profile of
the c1 driver shape showed ~30% of device time inside threefry2x32 — JAX's `fold_in` + `uniform((n,))` per bounce
runs the full 20-round cipher over ~6 counter blocks per lane per
iteration.  Threefry's cryptographic margin buys nothing here: path
tracing needs statistical uniformity and stream independence, not
preimage resistance.  The reference build has the same economics — its
samplers are PCG32, a 3-op LCG+output-mix generator
(``/root/reference/ext/mitsuba/include/mitsuba/core/random.h`` layout;
reference samplers at ``src/eradiate/scenes/measure/_core.py:142``).

The fast path is the **pcg4d hash** (Jarzynski & Olano, JCGT 2020,
"Hash Functions for GPU Rendering" — public domain construction, widely
used in production wavefront path tracers): a 4-word LCG step followed
by two rounds of cross-word multiply-add feedback and a xorshift.  Cost
per 4 outputs is ~16 32-bit multiply/adds and 4 xorshifts (32x32->low-32
multiplies; no 64-bit arithmetic, no rotates), far cheaper than the
threefry draw it replaces. Whether it still pays on the GPU is an open
item (ROADMAP, Speed).

Keying discipline is unchanged: the hash input is the lane's
*threefry-derived* key data (already keyed by pixel, global sample id
and spectral row — see ``tracer.render_sample_loop``), the bounce depth,
and a block index.  Sharding invariance, lane-count invariance and
chunk invariance are therefore inherited from the key derivation, which
stays threefry end to end; only the per-bounce *expansion* of that key
into uniforms changes.  Selected per scene via ``SceneConfig.rng``
("pcg4d" default | "threefry" for the legacy bit-stream).

Statistical quality: pcg4d passes the avalanche / bit-correlation
battery of the source paper; :mod:`tests/unit/test_fastrng.py` pins
uniformity (chi^2), serial correlation across depth/block/lane, and
mean/variance; the doubling/SOS anchors and the self-regression tier
(statistical, seed-independent) gate the full transport loop on it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["pcg4d", "bounce_uniforms", "uniforms_from_keys"]

_M = 1664525
_A = 1013904223
#: 1/2^24 — uniforms take the top 24 bits so float32 rounding never
#: produces 1.0 and the grid spacing is exactly representable.
_INV24 = 1.0 / (1 << 24)


def _u32(x):
    return jnp.asarray(x).astype(jnp.uint32)


def pcg4d(a, b, c, d):
    """One pcg4d mix over four uint32 words (broadcasting elementwise).

    Returns four well-mixed uint32 words. Construction: per-word LCG,
    cross-word multiply-add feedback, 16-bit xorshift, second feedback
    round (Jarzynski & Olano 2020, listing "pcg4d").
    """
    m = jnp.uint32(_M)
    inc = jnp.uint32(_A)
    a = a * m + inc
    b = b * m + inc
    c = c * m + inc
    d = d * m + inc
    a = a + b * d
    b = b + c * a
    c = c + a * b
    d = d + b * c
    a = a ^ (a >> 16)
    b = b ^ (b >> 16)
    c = c ^ (c >> 16)
    d = d ^ (d >> 16)
    a = a + b * d
    b = b + c * a
    c = c + a * b
    d = d + b * c
    return a, b, c, d


def _to_unit(x, dtype):
    # top 24 bits -> [0, 1) on the 2^-24 grid; strictly < 1 in f32.
    return (x >> jnp.uint32(8)).astype(dtype) * jnp.asarray(_INV24, dtype)


def uniforms_from_keys(keys, ctr, n, dtype=jnp.float32):
    """``[B, n]`` uniforms from per-lane typed PRNG keys and a counter.

    ``keys``: threefry keys, shape [B] (typed) — only their raw key data
    feeds the hash, so this is a pure expansion of the existing key
    stream.  ``ctr``: per-lane int32/uint32 counter (bounce depth).
    Block ``j`` of 4 outputs hashes ``(kd0, kd1, ctr, j)``; distinct
    blocks and counters decorrelate through the full mix.
    """
    kd = jax.random.key_data(keys).astype(jnp.uint32)  # [B, 2]
    kd0, kd1 = kd[..., 0], kd[..., 1]
    ctr = _u32(ctr)
    cols = []
    for j in range((n + 3) // 4):
        a, b, c, d = pcg4d(kd0, kd1, ctr, jnp.uint32(j))
        cols.extend([a, b, c, d])
    x = jnp.stack(cols[:n], axis=-1)
    return _to_unit(x, dtype)


#: domain salt for per-sample key derivation (golden-ratio word) — keeps
#: the derive hash inputs disjoint from bounce blocks (4th word is a
#: small block index there) and origin jitter (4th word 0x7A19).
_DERIVE_SALT = 0x9E3779B9
#: counter for the per-sample origin-jitter draw; bounce counters are
#: path depths (< max_depth ~ 64), so this never collides.
_ORIGIN_CTR = 0x7A19


def derive_keys(impl, row_keys_b, sid):
    """Per-sample lane keys from a broadcast row key and sample ids.

    The regenerative loops call this once per iteration; with
    ``impl == "pcg4d"`` the threefry ``fold_in`` is replaced by one pcg4d
    mix whose four output words fold into the 2-word key data (still a
    pure function of (row_key, global sample id): lane/quota/shard
    invariance is unchanged).
    """
    if impl == "threefry":
        return jax.vmap(jax.random.fold_in)(row_keys_b, sid)
    kd = jax.random.key_data(row_keys_b).astype(jnp.uint32)
    a, b, c, d = pcg4d(
        kd[..., 0], kd[..., 1], _u32(sid), jnp.uint32(_DERIVE_SALT)
    )
    return jax.random.wrap_key_data(jnp.stack([a ^ c, b ^ d], axis=-1))


def origin_uniforms(impl, keys, n=2, dtype=jnp.float32):
    """Per-sample origin-jitter uniforms [B, n] (rectangle targets)."""
    B = keys.shape[0]
    ctr = jnp.full(B, _ORIGIN_CTR, jnp.uint32)
    if impl == "threefry":
        return jax.vmap(lambda k: jax.random.uniform(k, (n,), dtype=dtype))(
            jax.vmap(jax.random.fold_in)(keys, ctr)
        )
    return uniforms_from_keys(keys, ctr, n, dtype=dtype)


def bounce_uniforms(impl, keys, depth_b, n, dtype=jnp.float32):
    """The per-bounce draw used by every tracer family.

    ``impl == "threefry"`` reproduces the legacy bit stream exactly
    (fold_in + uniform); ``"pcg4d"`` is the fast expansion above.
    """
    if impl == "threefry":
        k_iter = jax.vmap(jax.random.fold_in)(keys, depth_b)
        return jax.vmap(lambda k: jax.random.uniform(k, (n,), dtype=dtype))(
            k_iter
        )
    if impl != "pcg4d":
        raise ValueError(f"unknown rng impl: {impl!r}")
    return uniforms_from_keys(keys, depth_b, n, dtype=dtype)
