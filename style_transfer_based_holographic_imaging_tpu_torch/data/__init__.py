"""Golden-suite data, the measured ``.mat`` tree, hologram synthesis and the
host -> card prefetch."""

from style_transfer_based_holographic_imaging_tpu_torch.data.goldens import (
    GOLDEN_HELDOUT_BATCHES,
    GoldenSuite,
    load_golden_suite,
)
from style_transfer_based_holographic_imaging_tpu_torch.data.mat_loader import HoloMatDataset
from style_transfer_based_holographic_imaging_tpu_torch.data.mat_sampler import MeasuredHologramSampler
from style_transfer_based_holographic_imaging_tpu_torch.data.prefetch import prefetch_to_device
from style_transfer_based_holographic_imaging_tpu_torch.data.synth import synth_interpolation_batch

__all__ = [
    "GOLDEN_HELDOUT_BATCHES",
    "GoldenSuite",
    "load_golden_suite",
    "HoloMatDataset",
    "MeasuredHologramSampler",
    "prefetch_to_device",
    "synth_interpolation_batch",
]
