"""Evaluation metrics (port of the JAX ``eval/metrics.py``).

* ``psnr``: data_range defaults to ``target.max() - target.min()`` of the
  call's target batch (torchmetrics' behaviour with ``data_range=None``).
* ``mae``: mean absolute error.
* ``r2_score``: ``1 - SS_res / SS_tot``; for a constant target, 1.0 when the
  prediction is exact and 0.0 otherwise (sklearn), never nan.
"""

from __future__ import annotations

import torch

__all__ = ["psnr", "mae", "r2_score", "zero_mean", "distances_to_um"]


def psnr(pred, target, data_range: float | None = None) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB over the whole batch."""
    pred = torch.as_tensor(pred, dtype=torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32, device=pred.device)
    if data_range is None:
        rng = target.max() - target.min()
    else:
        rng = torch.tensor(data_range, dtype=torch.float32, device=pred.device)
    mse = torch.mean((pred - target) ** 2)
    return 10.0 * torch.log10(rng * rng / mse)


def mae(pred, target) -> torch.Tensor:
    pred = torch.as_tensor(pred)
    return torch.mean(torch.abs(pred - torch.as_tensor(target, device=pred.device)))


def r2_score(y_true, y_pred) -> torch.Tensor:
    y_true = torch.as_tensor(y_true, dtype=torch.float32).reshape(-1)
    y_pred = torch.as_tensor(y_pred, dtype=torch.float32, device=y_true.device).reshape(-1)
    ss_res = torch.sum((y_true - y_pred) ** 2)
    ss_tot = torch.sum((y_true - torch.mean(y_true)) ** 2)
    if ss_tot > 0.0:
        return 1.0 - ss_res / ss_tot
    return torch.where(ss_res > 0.0, 0.0, 1.0)


def zero_mean(x: torch.Tensor) -> torch.Tensor:
    """Remove the per-image spatial mean (phases are defined up to a global offset)."""
    return x - x.mean(dim=(-2, -1), keepdim=True)


def distances_to_um(d, physics):
    """Network-unit distances -> micrometres; numpy arrays or tensors."""
    return (d + physics.distance_normalize_constant) * physics.distance_normalize * 1000.0
