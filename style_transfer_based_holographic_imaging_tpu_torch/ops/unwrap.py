"""Least-squares 2D phase unwrapping (port of the JAX ``ops/unwrap.py``).

The weightless Poisson/DCT unwrap of Ghiglia & Romero (JOSA A 11, 1994):
wrapped forward differences, their divergence, a Neumann-Laplacian solve
diagonalized by an orthonormal DCT-II (applied as fp32 matrix products), and
an optional snap to congruence with the wrapped input.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = ["wrap_phase", "unwrap_phase"]

_TWO_PI = 2.0 * math.pi


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


def _dct_pair(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    return (
        torch.tensor(_dct_mat(h), device=device),
        torch.tensor(_dct_mat(w), device=device),
    )


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

    dh, dw = _dct_pair(h, w, phase.device)
    rho_hat = torch.matmul(torch.matmul(dh, rho), dw.T)
    psi_hat = rho_hat / denom
    psi_hat[..., 0, 0] = 0.0
    psi = torch.matmul(torch.matmul(dh.T, psi_hat), dw)

    if congruent:
        k = torch.round((psi - phase) / _TWO_PI)
        psi = phase + _TWO_PI * k
    return psi
