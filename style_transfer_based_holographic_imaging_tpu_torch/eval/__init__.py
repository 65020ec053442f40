"""Evaluation metrics."""

from style_transfer_based_holographic_imaging_tpu_torch.eval.metrics import (
    distances_to_um,
    mae,
    psnr,
    r2_score,
    zero_mean,
)

__all__ = ["psnr", "mae", "r2_score", "zero_mean", "distances_to_um"]
