"""Golden-suite data and the host -> card prefetch."""

from style_transfer_based_holographic_imaging_tpu_torch.data.goldens import (
    GOLDEN_HELDOUT_BATCHES,
    GoldenSuite,
    load_golden_suite,
)
from style_transfer_based_holographic_imaging_tpu_torch.data.prefetch import prefetch_to_device

__all__ = ["GOLDEN_HELDOUT_BATCHES", "GoldenSuite", "load_golden_suite", "prefetch_to_device"]
