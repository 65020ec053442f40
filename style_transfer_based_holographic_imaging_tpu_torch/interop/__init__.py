"""Converters from the JAX package's artifacts (numpy in, torch out)."""

from style_transfer_based_holographic_imaging_tpu_torch.interop.from_jax import (
    convert_params,
    convert_pipeline_state,
    convert_train_state,
    load_release_weights,
    load_style_vector,
    pipeline_state_to_jax,
)

__all__ = ["convert_params", "convert_train_state", "convert_pipeline_state", "pipeline_state_to_jax",
           "load_release_weights", "load_style_vector"]
