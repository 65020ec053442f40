"""``jax.random``'s threefry stream in numpy, bit for bit.

The JAX package keys its evaluation streams with ``jax.random`` (the domain
records' ``synth_batch`` batches, ``extract_style_vector``'s). The port
reproduces the calls those streams make, so that it can score a domain
release on the same holograms without JAX:

* ``key(seed)``, ``fold_in(key, data)``, ``split(key, num)``;
* ``random_bits(key, shape)`` (32-bit), ``randint``, ``uniform`` and
  ``bernoulli`` for ``int32`` and ``float32``.

A key is a ``(2,)`` ``uint32`` array (what ``jax.random.key_data`` gives);
``split`` returns ``(num, 2)``. The counters are JAX's "partitionable"
layout, its default since JAX 0.5 (``jax_threefry_partitionable``): the
counter of element ``i`` of a shape is the 64-bit ``i`` split into its high
and low 32-bit words, hashed under the key, and 32 random bits are the two
output words XOR-ed. Only uniform bits, integers and uniform floats are
reproduced: ``normal`` (the synthesis's warp) is not.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

__all__ = ["key", "fold_in", "split", "random_bits", "randint", "uniform", "bernoulli",
           "threefry2x32", "fma32"]

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(k1, k2, x1, x2) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash of the counter words ``(x1, x2)`` (uint32
    arrays of one shape) under the key ``(k1, k2)``: 20 rounds, a key
    injection after every four."""
    k1, k2 = _U32(k1), _U32(k2)
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    x = [np.array(x1, dtype=_U32, ndmin=1), np.array(x2, dtype=_U32, ndmin=1)]
    with np.errstate(over="ignore"):
        x[0] = x[0] + ks[0]
        x[1] = x[1] + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)``'s data: the seed's high and low 32-bit words
    (a 32-bit seed: ``[0, seed]``)."""
    seed = int(seed)
    if seed < 0:
        seed &= 0xFFFF_FFFF_FFFF_FFFF
    return np.array([(seed >> 32) & 0xFFFF_FFFF, seed & 0xFFFF_FFFF], dtype=_U32)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(k, data)``: the hash of the counter pair
    ``(0, uint32(data))``."""
    h1, h2 = threefry2x32(k[0], k[1], [0], [int(data) & 0xFFFF_FFFF])
    return np.array([h1[0], h2[0]], dtype=_U32)


def _counters(shape: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """The 64-bit row-major iota over ``shape`` as (high, low) uint32 words."""
    n = int(np.prod(shape, dtype=np.int64))
    iota = np.arange(n, dtype=np.uint64).reshape(tuple(shape))
    return (iota >> np.uint64(32)).astype(_U32), (iota & np.uint64(0xFFFF_FFFF)).astype(_U32)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(k, num)``'s data, ``(num, 2)``: the hash of the
    counters ``0 .. num - 1``."""
    hi, lo = _counters((num,))
    b1, b2 = threefry2x32(k[0], k[1], hi, lo)
    return np.stack([b1, b2], axis=-1)


def random_bits(k: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """32 random bits per element of ``shape`` (``jax.random.bits``)."""
    shape = tuple(int(s) for s in shape)
    hi, lo = _counters(shape)
    b1, b2 = threefry2x32(k[0], k[1], hi.reshape(-1), lo.reshape(-1))
    return (b1 ^ b2).reshape(shape)


def randint(k: np.ndarray, shape: Sequence[int], minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(k, shape, minval, maxval)`` in int32: two sub-keys'
    bits, ``(hi mod span) * (2^32 mod span) + (lo mod span)`` mod the span,
    in wrapping uint32 arithmetic; ``maxval`` above int32's range is clipped
    to it and widens the span by one; ``maxval <= minval`` gives ``minval``."""
    info = np.iinfo(np.int32)
    out_of_range = int(maxval) > info.max
    lo_v = np.int32(np.clip(int(minval), info.min, info.max))
    hi_v = np.int32(np.clip(int(maxval), info.min, info.max))
    k1, k2 = split(k, 2)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    with np.errstate(over="ignore"):
        span = np.array(np.int64(hi_v) - np.int64(lo_v), dtype=np.int64).astype(_U32)
        if hi_v <= lo_v:
            span = _U32(1)
        elif out_of_range:
            span = _U32(span + _U32(1))
        span = np.array(span, dtype=_U32)
        if span == 0:
            # a span of 2^32 wraps to 0: the remainders leave the bits as they are
            offset = lower
        else:
            multiplier = np.array(_U32(1 << 16) % span, dtype=_U32)
            multiplier = (multiplier * multiplier) % span
            offset = ((higher % span) * multiplier + (lower % span)) % span
        return (lo_v + offset.astype(np.int32)).astype(np.int32)


def fma32(a: np.ndarray, b, c) -> np.ndarray:
    """``a * b + c`` of fp32 operands rounded once to fp32 (a fused
    multiply-add). The product is exact in float64; the sum is split into
    float64 ``s + e`` exactly (TwoSum), and ``e`` breaks the one case where
    rounding ``s`` alone would differ: ``s`` on a midpoint between two fp32
    values."""
    p = np.asarray(a, np.float32).astype(np.float64) * np.float64(np.float32(b))
    c = np.float64(np.float32(c))
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    r = s.astype(np.float32)
    r64 = r.astype(np.float64)
    lower = np.where(s >= r64, r, np.nextafter(r, np.float32(-np.inf)))
    upper = np.where(s >= r64, np.nextafter(r, np.float32(np.inf)), r)
    mid = (lower.astype(np.float64) + upper.astype(np.float64)) / 2.0
    on_mid = (s == mid) & (e != 0)
    return np.where(on_mid, np.where(e > 0, upper, lower), r).astype(np.float32)


def uniform(k: np.ndarray, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``: the top 23
    bits as the mantissa of a float in [1, 2), minus 1, then
    ``max(minval, u * (maxval - minval) + minval)`` in fp32. XLA on the CPU
    contracts that multiply-add into one fused operation, so it is rounded
    once here too (``fma32``)."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = random_bits(k, shape)
    one = np.array(1.0, np.float32).view(_U32)
    u = ((bits >> _U32(32 - 23)) | one).view(np.float32) - np.float32(1.0)
    return np.maximum(lo, fma32(u, hi - lo, lo)).astype(np.float32)


def bernoulli(k: np.ndarray, p: float = 0.5, shape: Sequence[int] = ()) -> np.ndarray:
    """``jax.random.bernoulli(k, p, shape)``: ``uniform < p`` in fp32."""
    return uniform(k, shape) < np.float32(p)
