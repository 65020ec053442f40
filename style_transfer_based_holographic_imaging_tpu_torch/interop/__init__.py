"""Converters from the JAX package's artifacts (numpy in, torch out), the
reader of its orbax checkpoints (``orbax_read.py`` over ``ocdbt.py`` and
the C++ zstd decoder of ``zstd.py``; no orbax, TensorStore or zstd library),
and the reference's torch checkpoints (``torch_weights.py``; its ``.pt``
style vector reader is ``load_style_vector_pt`` here, ``load_style_vector``
the ``.npz`` one)."""

from style_transfer_based_holographic_imaging_tpu_torch.interop.from_jax import (
    convert_ablation_variables,
    convert_params,
    convert_pipeline_state,
    convert_train_state,
    load_release_weights,
    load_style_vector,
    pipeline_state_to_jax,
)
from style_transfer_based_holographic_imaging_tpu_torch.interop.torch_weights import (
    load_reference_checkpoint,
    save_style_vector_pt,
)
from style_transfer_based_holographic_imaging_tpu_torch.interop.torch_weights import (
    load_style_vector as load_style_vector_pt,
)

__all__ = ["convert_params", "convert_ablation_variables", "convert_train_state", "convert_pipeline_state",
           "pipeline_state_to_jax", "load_release_weights", "load_style_vector", "load_reference_checkpoint",
           "load_style_vector_pt", "save_style_vector_pt"]
