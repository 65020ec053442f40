"""Eager end-to-end pipelines."""

from style_transfer_based_holographic_imaging_tpu_torch.pipelines.autofocus import (
    autofocus,
    sharpness,
)
from style_transfer_based_holographic_imaging_tpu_torch.pipelines.domain_eval import (
    evaluate_synth_domain,
)
from style_transfer_based_holographic_imaging_tpu_torch.pipelines.field_retrieval import (
    evaluate_golden_suite,
    make_retrieval_fn,
    retrieval_step,
)
from style_transfer_based_holographic_imaging_tpu_torch.pipelines.mat_eval import (
    evaluate_mat_tree,
)
from style_transfer_based_holographic_imaging_tpu_torch.pipelines.refine import (
    physics_refine,
    refine_retrieval,
)
from style_transfer_based_holographic_imaging_tpu_torch.pipelines.server import (
    RetrievalService,
    retrieve_remote,
    serve_forever,
)
from style_transfer_based_holographic_imaging_tpu_torch.pipelines.streaming import (
    StreamStats,
    stream_retrieval,
)
from style_transfer_based_holographic_imaging_tpu_torch.pipelines.style_vector import (
    extract_style_vector,
    save_style_vector,
    style_vector_from_holograms,
)

__all__ = [
    "retrieval_step",
    "make_retrieval_fn",
    "evaluate_golden_suite",
    "evaluate_mat_tree",
    "evaluate_synth_domain",
    "extract_style_vector",
    "style_vector_from_holograms",
    "save_style_vector",
    "physics_refine",
    "refine_retrieval",
    "autofocus",
    "sharpness",
    "RetrievalService",
    "serve_forever",
    "retrieve_remote",
    "StreamStats",
    "stream_retrieval",
]
