"""FFT-domain sharding: the angular-spectrum propagation of a field whose
rows are split over a mesh axis (port of the JAX package's
``parallel/fft_sharding.py``).

A large hologram's field of view is split row-wise over the ranks of one
mesh axis, and the 2D FFT inside the propagator is taken by the transpose
decomposition, each collective one ``all_to_all`` (``parallel.mesh``):

    rows-sharded field
      -> local 1D FFT along columns (rows independent)
      -> all_to_all distributed transpose  (rows-sharded -> cols-sharded)
      -> local 1D FFT along rows
      -> multiply by the column shard of the transfer function H(d)
      -> local 1D iFFT along rows
      -> all_to_all back
      -> local 1D iFFT along columns

The JAX package pads, applies the global phasor and crops on the global
array and lets XLA place the few rows each shard needs. Here each rank
holds its rows of the unpadded field and returns its rows of the result:
the replicate pad takes, from the ranks that hold them, the source rows of
the rank's padded rows (``exchange_rows``; none cross ranks on two ranks),
and the crop takes the rank's rows of the cropped result back the same
way. The numerics are ``ops.asm.propagate_torch``'s (the same kz grid,
evanescent clamp, band-limit mask and phase split), with the 2D FFT taken
as two 1D passes: the two round differently, within 1e-5 of the field's
max (``tests/test_torch_fft_sharding.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from style_transfer_based_holographic_imaging_tpu_torch.ops.asm import (
    _fftfreq32,
    kz_rel_grid,
    pad_replicate,
)
from style_transfer_based_holographic_imaging_tpu_torch.parallel.mesh import (
    Mesh,
    NamedSharding,
    all_to_all,
    exchange_rows,
)

__all__ = ["sharded_propagate", "fov_sharding"]


def fov_sharding(mesh: Mesh, axis: str = "data", ndim: int = 4) -> NamedSharding:
    """The layout that splits the field-of-view rows (axis -2) over the mesh."""
    spec = [None] * ndim
    spec[-2] = axis
    return NamedSharding(mesh, tuple(spec))


def sharded_propagate(
    field: torch.Tensor,
    distance,
    *,
    mesh: Mesh,
    wavelength: float,
    pixel_size: float,
    pad: bool = True,
    band_limit: bool = False,
    axis: str = "data",
) -> torch.Tensor:
    """Angular-spectrum propagation of a row-sharded complex field, in this
    rank of ``mesh``'s world.

    Args:
      field: this rank's rows of a complex ``(B, C, H, W)`` field (its
        ``fov_sharding`` shard: ``H / N`` rows, ``N`` the size of
        ``mesh[axis]``; a real tensor is cast to complex64). The padded
        height ``2H`` and width ``2W`` (or ``H`` and ``W`` with ``pad=False``)
        must divide by ``N``.
      distance: metres, a scalar or ``(B, 1, 1, 1)``, the same on every rank.
      band_limit: the Matsushima-Shimobaba band-limited transfer function,
        as ``ops.asm.propagate``'s.

    Returns this rank's rows of the propagated field. Differentiable: the
    collectives carry their transposes.
    """
    n = mesh.shape[axis]
    group = mesh.groups()[axis]
    r = mesh.coords(dist.get_rank())[axis]
    if not field.is_complex():
        field = field.to(torch.complex64)
    h_loc, w = field.shape[-2], field.shape[-1]
    h = h_loc * n
    ph, pw = (h + 2 * (h // 2), w + 2 * (w // 2)) if pad else (h, w)
    if ph % n or pw % n:
        raise ValueError(f"padded field {ph}x{pw} not divisible by mesh axis {axis}={n}")
    rows, cols = ph // n, pw // n
    dev = field.device
    held = [(j * h_loc, (j + 1) * h_loc) for j in range(n)]

    if pad:
        # padded row p is source row clamp(p - h//2): each rank takes the
        # source rows of its padded rows from their holders
        top = h // 2

        def clamp(p):
            return min(max(p - top, 0), h - 1)

        need = [(clamp(j * rows), clamp((j + 1) * rows - 1) + 1) for j in range(n)]
        src = exchange_rows(field, -2, held, need, group)
        idx = (torch.arange(r * rows, (r + 1) * rows, device=dev) - top).clamp(0, h - 1) - need[r][0]
        x = pad_replicate(src.index_select(-2, idx), 0, w // 2)
    else:
        x = field

    kz = torch.tensor(kz_rel_grid(ph, pw, pixel_size=pixel_size, wavelength=wavelength)[:, r * cols:(r + 1) * cols],
                      device=dev)
    d = torch.as_tensor(distance, dtype=torch.float32, device=dev)
    d = d.broadcast_to(tuple(field.shape[:-2]) + (1, 1))

    y = torch.fft.fft(x, dim=-1)
    z = all_to_all(y, -1, -2, group)              # (B, C, PH, PW/N): the full columns of a shard
    s = torch.fft.fft(z, dim=-2)
    phase = d * kz
    transfer = torch.complex(torch.cos(phase), torch.sin(phase))
    if band_limit:
        # Matsushima & Shimobaba 2009, the mask of ops.asm.propagate_torch
        # on this rank's columns: fy whole, fx this rank's shard.
        fy = torch.tensor(_fftfreq32(ph, pixel_size), device=dev).abs()
        fx = torch.tensor(_fftfreq32(pw, pixel_size)[r * cols:(r + 1) * cols], device=dev).abs()
        d_abs = d.abs()
        span_h = float(np.float32(ph * pixel_size))
        span_w = float(np.float32(pw * pixel_size))
        fy_lim = 1.0 / (wavelength * torch.sqrt((2.0 * d_abs / span_h) ** 2 + 1.0))
        fx_lim = 1.0 / (wavelength * torch.sqrt((2.0 * d_abs / span_w) ** 2 + 1.0))
        mask = (fy[:, None] <= fy_lim) & (fx[None, :] <= fx_lim)
        transfer = transfer * mask.to(transfer.dtype)
    v = torch.fft.ifft(s * transfer, dim=-2)
    v = all_to_all(v, -2, -1, group)              # back to (B, C, PH/N, PW)
    out = torch.fft.ifft(v, dim=-1)

    # Global (frequency-independent) phasor exp(i d 2 pi / lambda).
    g_phase = d * float(np.float32(2.0 * math.pi / wavelength))
    out = out * torch.complex(torch.cos(g_phase), torch.sin(g_phase))
    if pad:
        # this rank's rows of the centre crop are padded rows h//2 + its rows
        held_p = [(j * rows, (j + 1) * rows) for j in range(n)]
        want = [(h // 2 + lo, h // 2 + hi) for lo, hi in held]
        out = exchange_rows(out, -2, held_p, want, group)
        left = (pw - w) // 2
        out = out[..., left:left + w]
    return out
