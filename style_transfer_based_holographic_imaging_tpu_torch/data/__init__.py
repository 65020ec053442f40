"""Golden-suite data."""

from style_transfer_based_holographic_imaging_tpu_torch.data.goldens import (
    GOLDEN_HELDOUT_BATCHES,
    GoldenSuite,
    load_golden_suite,
)

__all__ = ["GOLDEN_HELDOUT_BATCHES", "GoldenSuite", "load_golden_suite"]
