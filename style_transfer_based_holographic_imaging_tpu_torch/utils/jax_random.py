"""``jax.random``'s threefry stream in numpy, bit for bit.

The JAX package keys its evaluation streams with ``jax.random`` (the domain
records' ``synth_batch`` batches, ``extract_style_vector``'s). The port
reproduces the calls those streams make, so that it can score a domain
release on the same holograms without JAX:

* ``key(seed)``, ``fold_in(key, data)``, ``split(key, num)``;
* ``random_bits(key, shape)`` (32-bit), ``randint``, ``uniform``,
  ``bernoulli`` and ``normal`` for ``int32`` and ``float32``.

A key is a ``(2,)`` ``uint32`` array (what ``jax.random.key_data`` gives);
``split`` returns ``(num, 2)``. The counters are JAX's "partitionable"
layout, its default since JAX 0.5 (``jax_threefry_partitionable``): the
counter of element ``i`` of a shape is the 64-bit ``i`` split into its high
and low 32-bit words, hashed under the key, and 32 random bits are the two
output words XOR-ed.

``normal`` is ``sqrt(2) erfinv(u)`` of a uniform ``u`` on ``(-1, 1)``, with
XLA's float32 ``ErfInv`` (a degree-8 polynomial in ``log1p(-u^2)``) and the
``log1p`` and ``log`` that XLA's CPU backend emits (Cephes' rational and
polynomial), each multiply-add fused as XLA fuses it: over 600,000 draws of
three keys 99.996 % of elements are bit for bit and the rest within 2 ulp.
scipy's correctly rounded ``erfinv`` reads up to 91 ulp off.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

__all__ = ["key", "fold_in", "split", "random_bits", "randint", "uniform", "bernoulli", "normal",
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
    counters ``0 .. num - 1``. Keys ``(..., 2)`` split each: ``(..., num, 2)``
    (``jax.vmap`` of it)."""
    k = np.asarray(k, _U32)
    hi, lo = _counters((num,))
    b1, b2 = threefry2x32(k[..., 0, None], k[..., 1, None], hi, lo)
    return np.stack([b1, b2], axis=-1).reshape(k.shape[:-1] + (num, 2))


def random_bits(k: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """32 random bits per element of ``shape`` (``jax.random.bits``). Keys
    ``(..., 2)`` draw each: ``(...) + shape``."""
    k = np.asarray(k, _U32)
    shape = tuple(int(s) for s in shape)
    hi, lo = _counters(shape)
    b1, b2 = threefry2x32(k[..., 0, None], k[..., 1, None], hi.reshape(-1), lo.reshape(-1))
    return (b1 ^ b2).reshape(k.shape[:-1] + shape)


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
    """``a * b + c`` of fp32 operands (arrays or scalars that broadcast)
    rounded once to fp32 (a fused multiply-add). The product is exact in
    float64; the sum is split into float64 ``s + e`` exactly (TwoSum), and
    ``e`` breaks the one case where rounding ``s`` alone would differ: ``s``
    on a midpoint between two fp32 values."""
    p = np.asarray(a, np.float32).astype(np.float64) * np.asarray(b, np.float32).astype(np.float64)
    c = np.asarray(c, np.float32).astype(np.float64)
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
    """``jax.random.uniform(k, shape, float32, minval, maxval)`` (keys
    ``(..., 2)``: ``(...) + shape``, as ``random_bits``): the top 23
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


_F32 = np.float32
# XLA's float32 ErfInv: the polynomial's coefficients, highest degree first,
# for w = -log1p(-x^2) below 5 (in w - 2.5) and from 5 (in sqrt(w) - 3).
_ERFINV_LT5 = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                        0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941],
                       _F32)
_ERFINV_GE5 = np.array([-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                        0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682], _F32)
# XLA's log1p for |x| below sqrt(2) - 1: Cephes' rational P(x) / Q(x).
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
              2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
              3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1)
# XLA's CPU log: Cephes' logf polynomial.
_LOG_P = tuple(_F32(v) for v in (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
                                 -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
                                 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))


def _log32(x: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 ``log`` of positive normal ``x``: the mantissa in
    [sqrt(1/2), sqrt(2)) minus one, Cephes' polynomial, the exponent times
    ln 2 in two parts."""
    bits = x.astype(_F32).view(np.int32)
    e = (_F32(1.0) + ((bits >> 23) - 0x7F).astype(_F32)).astype(_F32)
    m = ((bits & ~0x7F800000) | np.int32(0x3F000000)).view(_F32)        # [0.5, 1)
    small = m < _F32(0.707106781186547524)
    t = ((m - _F32(1.0)).astype(_F32) + np.where(small, m, _F32(0.0))).astype(_F32)
    e = (e - np.where(small, _F32(1.0), _F32(0.0))).astype(_F32)
    x2 = (t * t).astype(_F32)
    x3 = (x2 * t).astype(_F32)
    p = _LOG_P
    y = fma32(fma32(t, p[0], p[1]), t, p[2])
    y1 = fma32(fma32(t, p[3], p[4]), t, p[5])
    y2 = fma32(fma32(t, p[6], p[7]), t, p[8])
    y = (fma32(fma32(y, x3, y1), x3, y2) * x3).astype(_F32)
    y = (y + (_F32(-2.12194440e-4) * e).astype(_F32)).astype(_F32)
    t = (t - (_F32(0.5) * x2).astype(_F32)).astype(_F32)
    return ((t + y).astype(_F32) + (_F32(0.693359375) * e).astype(_F32)).astype(_F32)


def _log1p32(x: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 ``log1p`` of ``x`` in (-1, 0]: Cephes' rational
    below sqrt(2) - 1 in magnitude (its Horner steps fused), else
    ``log(1 + x)``."""
    x = x.astype(_F32)
    x2 = (x * x).astype(_F32)
    num = np.zeros_like(x)
    den = np.zeros_like(x)
    for cn, cd in zip(_LOG1P_NUM, _LOG1P_DEN):
        num = fma32(num, x, _F32(cn))
        den = fma32(den, x, _F32(cd))
    small = ((x * x2).astype(_F32) * (num / den).astype(_F32)).astype(_F32)
    small = (x + fma32(_F32(-0.5), x2, small)).astype(_F32)
    with np.errstate(divide="ignore", invalid="ignore"):
        large = _log32((x + _F32(1.0)).astype(_F32))
    return np.where(np.abs(x) < _F32(0.41421356237309504880), small, large).astype(_F32)


def normal(k: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.normal(k, shape, float32)``: ``sqrt(2) erfinv(u)`` of
    ``u = uniform(k, shape, nextafter(-1, 0), 1)``, XLA's float32
    ``ErfInv`` (see the module docstring). Keys ``(..., 2)`` draw each, as
    ``uniform`` and ``random_bits`` do."""
    lo = np.nextafter(_F32(-1.0), _F32(0.0))
    x = uniform(k, shape, lo, _F32(1.0))
    w = -_log1p32(-(x * x).astype(_F32))
    lt = w < _F32(5.0)
    w = np.where(lt, (w - _F32(2.5)).astype(_F32), (np.sqrt(w) - _F32(3.0)).astype(_F32))
    p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).astype(_F32)
    for lt5, ge5 in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma32(p, w, np.where(lt, lt5, ge5))
    r = (p * x).astype(_F32)
    with np.errstate(over="ignore", invalid="ignore"):
        r = np.where(np.abs(x) == _F32(1.0), x * _F32(np.inf), r)
    return (_F32(np.sqrt(2.0)) * r).astype(_F32)
