"""Eager end-to-end pipelines."""

from style_transfer_based_holographic_imaging_tpu_torch.pipelines.field_retrieval import (
    evaluate_golden_suite,
    make_retrieval_fn,
    retrieval_step,
)

__all__ = ["retrieval_step", "make_retrieval_fn", "evaluate_golden_suite"]
