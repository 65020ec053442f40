"""Physics and feature-statistics ops."""

from style_transfer_based_holographic_imaging_tpu_torch.ops.asm import (
    center_crop,
    kz_rel_grid,
    pad_replicate,
    propagate,
    propagate_torch,
    set_asm_backend,
)
from style_transfer_based_holographic_imaging_tpu_torch.ops.holo import back_prop, holo_forward
from style_transfer_based_holographic_imaging_tpu_torch.ops.stats import (
    adain,
    adain_with_stats,
    calc_mean_std,
)
from style_transfer_based_holographic_imaging_tpu_torch.ops.unwrap import unwrap_phase, wrap_phase

__all__ = [
    "kz_rel_grid",
    "propagate",
    "propagate_torch",
    "center_crop",
    "pad_replicate",
    "set_asm_backend",
    "holo_forward",
    "back_prop",
    "calc_mean_std",
    "adain",
    "adain_with_stats",
    "unwrap_phase",
    "wrap_phase",
]
