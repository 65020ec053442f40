"""Angular-spectrum-method (ASM) free-space propagation in PyTorch.

Port of the JAX package's ``ops/asm.py``. Semantics kept exactly:

* replicate padding to ``pad_factor`` x the spatial size before the FFT;
* the transfer-function phase split into a relative grid (``kz_rel_grid``,
  |phase| < ~300 rad) and a global per-sample phasor ``exp(i d 2pi/lambda)``
  applied after the inverse FFT, so fp32 never sees ~1e4-radian arguments;
* the evanescent band clamped to a unit transfer function;
* the optional Matsushima-Shimobaba band limit;
* centre crop back to the input size.

Backends: ``"torch"`` (the ``torch.fft`` composition, always available),
``"cuda"`` (the hand-written Hopper kernels of ``kernels/asm_cuda.py``) and
``"auto"`` (the default: ``cuda`` for an eligible CUDA tensor, ``torch``
otherwise). ``"cuda"`` on an ineligible shape raises. The process-wide
backend is ``set_asm_backend`` or the ``STHI_ASM_BACKEND`` environment
variable (read at import; ``cli --asm-backend`` sets it); a per-call
``backend`` overrides it.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake

__all__ = [
    "kz_rel_grid",
    "propagate",
    "propagate_torch",
    "center_crop",
    "pad_replicate",
    "set_asm_backend",
]

_BACKENDS = ("torch", "cuda", "auto")
_BACKEND = os.environ.get("STHI_ASM_BACKEND", "auto").lower()
if _BACKEND not in _BACKENDS:
    raise ValueError(f"STHI_ASM_BACKEND={_BACKEND!r} is not one of 'torch'|'cuda'|'auto'")
# The fused DFT-matmul kernels evaluate O(n^3) DFT products; beyond this
# side the FFT composition wins (and the JAX kernel's VMEM budget ended here).
_CUDA_MAX_SIDE = 256


def set_asm_backend(name: str) -> None:
    """The process-wide propagator backend: 'torch' | 'cuda' | 'auto'."""
    global _BACKEND
    if name not in _BACKENDS:
        raise ValueError(f"unknown ASM backend {name!r}")
    _BACKEND = name


def _fftfreq32(n: int, d: float) -> np.ndarray:
    """``jnp.fft.fftfreq(n, d)`` in fp32 as XLA compiles it under ``jit``:
    integer bins times the fp32 reciprocal of the constant ``n*d`` (XLA folds
    the division by a constant into that product; the grid then matches the
    JAX package's bit for bit)."""
    i = np.arange(n, dtype=np.float32)
    k = (i + np.float32(n // 2)) % np.float32(n) - np.float32(n // 2)
    return (k * (np.float32(1.0) / np.float32(d * n))).astype(np.float32)


@functools.lru_cache(maxsize=16)
def kz_rel_grid(height: int, width: int, *, pixel_size: float, wavelength: float) -> np.ndarray:
    """Relative axial wavenumber grid ``2 pi (sqrt(1/l^2 - f^2) - 1/l)``, fp32.

    Computed on the host in fp32 with the cancellation-free identity
    ``sqrt(a^2 - f^2) - a == -f^2 / (sqrt(a^2 - f^2) + a)``. In the
    evanescent band the grid is exactly ``-2 pi / lambda`` so that the
    global phasor cancels it (H = 1 there). The array is read-only: it is
    shared by every caller.
    """
    fy = _fftfreq32(height, pixel_size)
    fx = _fftfreq32(width, pixel_size)
    f_sq = fy[:, None] ** 2 + fx[None, :] ** 2
    inv_l = 1.0 / wavelength
    inv_l_sq32 = np.float32(inv_l * inv_l)
    root = np.sqrt(np.maximum(inv_l_sq32 - f_sq, np.float32(0.0)))
    rel = -f_sq / (root + np.float32(inv_l))
    rel = np.where(f_sq >= inv_l_sq32, np.float32(-inv_l), rel)
    out = (np.float32(2.0 * math.pi) * rel).astype(np.float32)
    out.setflags(write=False)
    return out


def _make_grids(height: int, width: int, pixel_size: float, wavelength: float, device: torch.device):
    """``kz_rel_grid`` and the absolute fp32 frequencies ``|fy|``, ``|fx|``
    of a padded grid, on ``device``; plain tensors even under
    ``torch.inference_mode``, so that a later differentiated call may use
    them."""
    with torch.inference_mode(False):
        kz_rel = torch.tensor(kz_rel_grid(height, width, pixel_size=pixel_size, wavelength=wavelength),
                              device=device)
        fy = torch.tensor(_fftfreq32(height, pixel_size), device=device).abs()
        fx = torch.tensor(_fftfreq32(width, pixel_size), device=device).abs()
    return kz_rel, fy, fx


_cached_grids = functools.lru_cache(maxsize=16)(_make_grids)


def _device_grids(field: torch.Tensor, height: int, width: int, pixel_size: float, wavelength: float):
    """``_make_grids`` on ``field``'s device, made once for real tensors: a
    copy from host memory at every call would wait there for the card to
    drain its queue, three times a propagation. Shared by every caller:
    read them, never write. A traced call (fake tensors, ``torch.compile``)
    makes its own."""
    if torch.compiler.is_compiling() or is_fake(field):
        return _make_grids(height, width, pixel_size, wavelength, field.device)
    return _cached_grids(height, width, pixel_size, wavelength, field.device)


def pad_replicate(field: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """Edge-replicate pad of the trailing two axes (any dtype, complex too)."""
    h, w = field.shape[-2], field.shape[-1]
    iy = torch.arange(-pad_h, h + pad_h, device=field.device).clamp_(0, h - 1)
    ix = torch.arange(-pad_w, w + pad_w, device=field.device).clamp_(0, w - 1)
    return field.index_select(-2, iy).index_select(-1, ix)


def center_crop(field: torch.Tensor, size_h: int, size_w: int | None = None) -> torch.Tensor:
    """Centre-crop the trailing two axes."""
    if size_w is None:
        size_w = size_h
    h, w = field.shape[-2], field.shape[-1]
    top = (h - size_h) // 2
    left = (w - size_w) // 2
    return field[..., top : top + size_h, left : left + size_w]


def _cuda_eligible(h: int, w: int, *, pad: bool, pad_factor: int, band_limit: bool) -> bool:
    """The shapes and options the fused CUDA kernels implement."""
    return (
        pad
        and pad_factor == 2
        and not band_limit
        and h % 2 == 0
        and w % 2 == 0
        and min(h, w) >= 16
        and max(h, w) <= _CUDA_MAX_SIDE
    )


def propagate(
    field: torch.Tensor,
    distance,
    *,
    wavelength: float,
    pixel_size: float,
    pad: bool = True,
    pad_factor: int = 2,
    band_limit: bool = False,
    backend: str | None = None,
) -> torch.Tensor:
    """Propagate a complex field by ``distance`` metres via the angular spectrum.

    Args:
      field: complex tensor ``(..., H, W)``; a real tensor is cast to complex64.
      distance: metres; a host scalar (routes to the constant-transfer-function
        kernel), or a tensor broadcastable to the leading axes of ``field``
        (e.g. ``(B, 1, 1, 1)``: one distance per sample).
      backend: ``"torch"``, ``"cuda"`` or ``"auto"``; None takes the
        process-wide backend (``set_asm_backend``, ``"auto"`` by default).

    Returns:
      The propagated complex field, same shape as ``field``.
    """
    if not field.is_complex():
        field = field.to(torch.complex64)
    h, w = field.shape[-2], field.shape[-1]
    backend = _BACKEND if backend is None else backend
    if backend not in _BACKENDS:
        raise ValueError(f"unknown ASM backend {backend!r}")
    eligible = _cuda_eligible(h, w, pad=pad, pad_factor=pad_factor, band_limit=band_limit)
    if backend == "auto":
        backend = "cuda" if (eligible and field.is_cuda) else "torch"
    elif backend == "cuda" and not eligible:
        raise ValueError(
            "backend='cuda' requires pad=True, pad_factor=2, band_limit=False "
            f"and even H/W in [16, {_CUDA_MAX_SIDE}] (got pad={pad}, "
            f"pad_factor={pad_factor}, band_limit={band_limit}, shape {h}x{w}); "
            "use backend='auto' for best-effort"
        )
    if backend == "cuda":
        from style_transfer_based_holographic_imaging_tpu_torch.kernels.asm_cuda import (
            propagate_cuda,
        )

        return propagate_cuda(field, distance, wavelength=wavelength, pixel_size=pixel_size)
    return propagate_torch(
        field,
        distance,
        wavelength=wavelength,
        pixel_size=pixel_size,
        pad=pad,
        pad_factor=pad_factor,
        band_limit=band_limit,
    )


def propagate_torch(
    field: torch.Tensor,
    distance,
    *,
    wavelength: float,
    pixel_size: float,
    pad: bool = True,
    pad_factor: int = 2,
    band_limit: bool = False,
) -> torch.Tensor:
    """The ``torch.fft`` composition (fft2 -> xH -> ifft2 -> crop); the
    reference every kernel is held against."""
    if not field.is_complex():
        field = field.to(torch.complex64)
    h, w = field.shape[-2], field.shape[-1]
    dev = field.device
    if pad:
        field = pad_replicate(field, h * (pad_factor - 1) // 2, w * (pad_factor - 1) // 2)
    ph, pw = field.shape[-2], field.shape[-1]

    kz_rel, fy, fx = _device_grids(field, ph, pw, pixel_size, wavelength)
    d = torch.as_tensor(distance, dtype=torch.float32, device=dev)
    phase = d * kz_rel
    transfer = torch.complex(torch.cos(phase), torch.sin(phase))

    if band_limit:
        # Matsushima & Shimobaba 2009: beyond f_lim the sampled transfer
        # function's local fringe frequency aliases; zero it.
        d_abs = d.abs()
        span_h = float(np.float32(ph * pixel_size))
        span_w = float(np.float32(pw * pixel_size))
        fy_lim = 1.0 / (wavelength * torch.sqrt((2.0 * d_abs / span_h) ** 2 + 1.0))
        fx_lim = 1.0 / (wavelength * torch.sqrt((2.0 * d_abs / span_w) ** 2 + 1.0))
        mask = (fy[:, None] <= fy_lim) & (fx[None, :] <= fx_lim)
        transfer = transfer * mask.to(transfer.dtype)

    spectrum = torch.fft.fft2(field)
    out = torch.fft.ifft2(transfer * spectrum)

    # Global (frequency-independent) phasor exp(i d 2 pi / lambda).
    g_phase = d * float(np.float32(2.0 * math.pi / wavelength))
    out = out * torch.complex(torch.cos(g_phase), torch.sin(g_phase))

    if pad:
        out = center_crop(out, h, w)
    return out
