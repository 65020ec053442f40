"""Least-squares 2D phase unwrapping (port of the JAX ``ops/unwrap.py``).

The weightless Poisson/DCT unwrap of Ghiglia & Romero (JOSA A 11, 1994):
wrapped forward differences, their divergence, a Neumann-Laplacian solve
diagonalized by an orthonormal DCT-II, and an optional snap to congruence
with the wrapped input.

Two process-wide switches, the JAX package's, pick how the DCTs run:

* ``set_dct_backend``: ``"matmul"`` applies the orthonormal DCT-II matrices
  with ``torch.matmul``; ``"fft"`` computes the DCT-II and its inverse from
  one complex FFT of the even/odd reordered signal (Makhoul, IEEE ASSP 28,
  1980) in fp32, as ``jax.scipy.fft.dctn``/``idctn(type=2, norm="ortho")``;
  ``"auto"`` (the default) takes the matmul up to 512 points a side and the
  FFT beyond.
* ``set_dct_precision`` (the matmul form only): ``"highest"`` multiplies in
  fp32 (TF32 stays off), ``"high"`` as three products of bf16-rounded
  operands, ``hi = bf16(x)``, ``lo = bf16(x - hi)``, ``hi hi + hi lo + lo
  hi`` summed in fp32 (the rule of the ASM kernels' ``high`` mode), on the
  CPU and on the card alike. With ``congruent=True`` the snap absorbs the
  difference.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = ["wrap_phase", "unwrap_phase", "set_dct_backend", "set_dct_precision"]

_TWO_PI = 2.0 * math.pi
_DCT_BACKEND = "auto"
_DCT_PRECISION = "highest"
_MATMUL_MAX = 512  # "auto": the matmul up to this many points a side


def set_dct_backend(backend: str) -> None:
    """The DCT of every later unwrap: ``auto``, ``fft`` or ``matmul``."""
    global _DCT_BACKEND
    if backend not in ("auto", "fft", "matmul"):
        raise ValueError(f"unknown dct backend {backend!r}")
    _DCT_BACKEND = backend


def set_dct_precision(precision: str) -> None:
    """The matmul DCT's products: ``highest`` (fp32) or ``high`` (three bf16)."""
    global _DCT_PRECISION
    if precision not in ("highest", "high"):
        raise ValueError(f"unknown dct precision {precision!r}")
    _DCT_PRECISION = precision


def wrap_phase(x: torch.Tensor) -> torch.Tensor:
    """Wrap values into [-pi, pi)."""
    return torch.remainder(x + math.pi, _TWO_PI) - math.pi


@functools.lru_cache(maxsize=8)
def _dct_mat(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (fp64 on the host, cast to fp32):
    ``D @ x == dct(x, type=2, norm='ortho')``."""
    k = np.arange(n)[:, None]
    m = np.cos(np.pi * (2.0 * np.arange(n)[None, :] + 1.0) * k / (2.0 * n))
    m *= np.sqrt(2.0 / n)
    m[0] *= np.sqrt(0.5)
    out = m.astype(np.float32)
    out.setflags(write=False)
    return out


def _split_hi_lo(m: torch.Tensor):
    """(hi, lo) of an fp32 tensor as fp32 values on the bf16 grid: hi =
    bf16(m), lo = bf16(m - hi)."""
    hi = m.to(torch.bfloat16).float()
    return hi, (m - hi).to(torch.bfloat16).float()


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _DCT_PRECISION == "highest":
        return torch.matmul(a, b)
    (a_hi, a_lo), (b_hi, b_lo) = _split_hi_lo(a), _split_hi_lo(b)
    return torch.matmul(a_hi, b_hi) + torch.matmul(a_hi, b_lo) + torch.matmul(a_lo, b_hi)


def _ortho_scale(n: int, device) -> torch.Tensor:
    """2 f(k) of the orthonormal DCT-II: sqrt(1/n) at k = 0, sqrt(2/n) beyond."""
    s = torch.full((n,), math.sqrt(2.0 / n), dtype=torch.float32, device=device)
    s[0] = math.sqrt(1.0 / n)
    return s


def _twiddle(n: int, device) -> torch.Tensor:
    """exp(-i pi k / (2 n)), k = 0..n-1 (angles in fp64, cast to complex64)."""
    return torch.polar(torch.ones(n, dtype=torch.float64),
                       -math.pi * torch.arange(n, dtype=torch.float64) / (2 * n)).to(torch.complex64).to(device)


def _dct_last(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal DCT-II along the last axis from one FFT: v = (x[0::2],
    reversed x[1::2]), X[k] = 2 f(k) Re(exp(-i pi k / 2n) fft(v)[k])."""
    n = x.shape[-1]
    v = torch.cat([x[..., ::2], x[..., 1::2].flip(-1)], dim=-1)
    z = torch.fft.fft(v, dim=-1) * _twiddle(n, x.device)
    return z.real * _ortho_scale(n, x.device)


def _idct_last(y: torch.Tensor) -> torch.Tensor:
    """The inverse of ``_dct_last`` (DCT-III): with u = y / (2 f) (half the
    unnormalized DCT-II), V[k] = exp(i pi k / 2n) (u[k] - i u[n-k]) (u[n] =
    0) is fft(v), so v = Re(ifft(V)), x[2m] = v[m], x[2m+1] = v[n-1-m]."""
    n = y.shape[-1]
    u = y / _ortho_scale(n, y.device)
    u_rev = torch.cat([torch.zeros_like(u[..., :1]), u[..., 1:].flip(-1)], dim=-1)   # u[n-k]
    v = torch.fft.ifft(torch.complex(u, -u_rev) * _twiddle(n, y.device).conj(), dim=-1).real
    x = torch.empty_like(v)
    half = (n + 1) // 2
    x[..., ::2] = v[..., :half]
    x[..., 1::2] = v[..., half:].flip(-1)
    return x


def _dct2(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The orthonormal 2D DCT-II (or its inverse) over the last two axes."""
    h, w = x.shape[-2], x.shape[-1]
    use_matmul = max(h, w) <= _MATMUL_MAX if _DCT_BACKEND == "auto" else _DCT_BACKEND == "matmul"
    if not use_matmul:
        one = _idct_last if inverse else _dct_last
        return one(one(x).transpose(-1, -2)).transpose(-1, -2)
    dh = torch.tensor(_dct_mat(h), device=x.device)
    dw = torch.tensor(_dct_mat(w), device=x.device)
    if inverse:
        # orthonormal: the inverse is the transpose
        return _matmul(_matmul(dh.T, x), dw)
    return _matmul(_matmul(dh, x), dw.T)


def unwrap_phase(phase: torch.Tensor, *, congruent: bool = True) -> torch.Tensor:
    """Least-squares unwrap of wrapped phases ``(..., H, W)``, batched.

    With ``congruent=True`` each output pixel differs from the input by an
    exact multiple of 2 pi. The result is defined up to a global constant.
    """
    phase = torch.as_tensor(phase, dtype=torch.float32)
    h, w = phase.shape[-2], phase.shape[-1]

    # Wrapped gradients along each axis, zero flux at the border.
    dy = wrap_phase(torch.diff(phase, dim=-2))
    dx = wrap_phase(torch.diff(phase, dim=-1))
    zeros_row = torch.zeros_like(phase[..., :1, :])
    zeros_col = torch.zeros_like(phase[..., :, :1])
    dy = torch.cat([zeros_row, dy], dim=-2)
    dx = torch.cat([zeros_col, dx], dim=-1)

    rho = (
        torch.cat([dy[..., 1:, :], zeros_row], dim=-2)
        - dy
        + torch.cat([dx[..., :, 1:], zeros_col], dim=-1)
        - dx
    )

    iy = torch.arange(h, dtype=torch.float32, device=phase.device)
    ix = torch.arange(w, dtype=torch.float32, device=phase.device)
    denom = 2.0 * (torch.cos(math.pi * iy / h)[:, None] - 1.0) + 2.0 * (
        torch.cos(math.pi * ix / w)[None, :] - 1.0
    )
    denom[0, 0] = 1.0  # the DC term is arbitrary; pinned below

    psi_hat = _dct2(rho, inverse=False) / denom
    psi_hat[..., 0, 0] = 0.0
    psi = _dct2(psi_hat, inverse=True)

    if congruent:
        k = torch.round((psi - phase) / _TWO_PI)
        psi = phase + _TWO_PI * k
    return psi
