"""Network-free autofocus: the recording distance by sharpness search (port of
the JAX package's ``pipelines/autofocus.py``).

The measured hologram is back-propagated over a grid of candidate distances
and each sample takes the candidate whose refocused field is sharpest, in a
coarse pass and a fine pass around the winner. Candidates run one after the
other, each over the whole batch (the JAX package ``vmap``s them).

Metrics, each argmax-sharpest:

* ``"tamura"``: minus the Tamura coefficient of the amplitude,
  ``-sqrt(std/mean)``; phase objects show the least amplitude contrast at
  focus.
* ``"grad"``: mean gradient-magnitude energy of the amplitude (amplitude
  objects).
* ``"sparsity"``: minus the L1/L2 ratio of the gradient magnitude (edge
  sparsity, amplitude objects).

The JAX package pins its propagator to XLA here, so the port pins it to
``torch.fft``: this search runs no kernel of the port.
"""

from __future__ import annotations

from typing import Tuple

import torch

from style_transfer_based_holographic_imaging_tpu_torch.config import PhysicsConfig
from style_transfer_based_holographic_imaging_tpu_torch.ops.asm import propagate

__all__ = ["sharpness", "autofocus"]

_EPS = 1e-12


def sharpness(field: torch.Tensor, metric: str = "tamura") -> torch.Tensor:
    """Per-sample sharpness of a complex field ``(..., 1, H, W)`` (argmax =
    in focus)."""
    amp = field.abs()
    if metric == "tamura":
        mu = amp.mean(dim=(-2, -1))
        sd = amp.std(dim=(-2, -1), correction=0)
        return -torch.sqrt(sd / (mu + _EPS))[..., 0]
    gy = torch.diff(amp, dim=-2)[..., :, :-1]
    gx = torch.diff(amp, dim=-1)[..., :-1, :]
    gmag = torch.sqrt(gx * gx + gy * gy + _EPS)
    if metric == "grad":
        return (gmag * gmag).mean(dim=(-2, -1))[..., 0]
    if metric == "sparsity":
        l1 = gmag.sum(dim=(-2, -1))
        l2 = torch.sqrt((gmag * gmag).sum(dim=(-2, -1)))
        return -(l1 / (l2 + _EPS))[..., 0]
    raise ValueError(f"unknown sharpness metric {metric!r}")


def _linspace32(start, stop, num: int, device) -> torch.Tensor:
    """``jnp.linspace(start, stop, num, dtype=float32)`` with its fp32 ops:
    ``start (1 - s) + stop s`` over ``s = i / (num - 1)``, the last entry
    ``stop`` itself. ``start`` and ``stop`` are scalars or tensors."""
    f32 = dict(dtype=torch.float32, device=device)
    start = torch.as_tensor(start, **f32)
    stop = torch.as_tensor(stop, **f32)
    if num == 1:
        return start.reshape(1, *start.shape)
    div = num - 1
    s = torch.arange(div, **f32) / torch.tensor(float(div), **f32)
    s = s.reshape(div, *([1] * start.ndim))
    out = start * (1 - s) + stop * s
    return torch.cat([out, torch.broadcast_to(stop, out.shape[1:])[None]])


@torch.no_grad()
def autofocus(
    holo,
    d_min: float,
    d_max: float,
    physics: PhysicsConfig,
    *,
    n_coarse: int = 32,
    n_fine: int = 16,
    metric: str = "tamura",
    pad: bool = True,
    device: str | torch.device = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Coarse-to-fine autofocus of an intensity-hologram batch.

    Args:
      holo: ``(B, 1, H, W)`` recorded intensities.
      d_min, d_max: search range in network units (``physics.to_metres``).
      n_coarse: candidates across [d_min, d_max] in the first pass.
      n_fine: candidates across +-1 coarse step around the winner.
      metric: "tamura" (phase objects) | "grad" (amplitude objects) |
        "sparsity" (edge sparsity).
      device: where the search runs.

    Returns:
      ``(d_best, score_best, d_grid)``: per-sample distances ``(B,)``, their
      sharpness ``(B,)`` and the coarse grid ``(n_coarse,)``, in network
      units.
    """
    device = torch.device(device)
    field0 = torch.sqrt(torch.as_tensor(holo, dtype=torch.float32, device=device)).to(torch.complex64)

    def refocus_score(d):
        # Back to the object plane: the negative distance, as the refocus.
        out = propagate(
            field0,
            -physics.to_metres(d),
            wavelength=physics.wavelength,
            pixel_size=physics.pixel_size,
            pad=pad,
            pad_factor=physics.pad_factor,
            band_limit=physics.band_limit,
            backend="torch",
        )
        return sharpness(out, metric)  # (B,)

    def scores_of(cands):  # (N, B) or (N,) candidates -> (N, B) scores
        return torch.stack([refocus_score(c.reshape(-1, 1, 1, 1)) for c in cands])

    d_grid = _linspace32(d_min, d_max, n_coarse, device)
    best = scores_of(d_grid).argmax(dim=0)  # (B,)
    step = (d_max - d_min) / max(n_coarse - 1, 1)
    d_coarse = d_grid[best]

    offs = _linspace32(-step, step, n_fine, device)  # (Nf,)
    d_fine = (d_coarse[None, :] + offs[:, None]).clamp(d_min, d_max)  # (Nf, B)
    scores_f = scores_of(d_fine)
    best_f = scores_f.argmax(dim=0)
    b_idx = torch.arange(d_fine.shape[1], device=device)
    return d_fine[best_f, b_idx], scores_f[best_f, b_idx], d_grid
