"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``, built at first use)."""

from style_transfer_based_holographic_imaging_tpu_torch.kernels.asm_cuda import (
    LAUNCHES,
    asm_const,
    asm_const_plain,
    asm_dynamic,
    asm_dynamic_plain,
    propagate_cuda,
    reset_launches,
    set_dft_precision,
)

__all__ = [
    "LAUNCHES",
    "asm_const",
    "asm_const_plain",
    "asm_dynamic",
    "asm_dynamic_plain",
    "propagate_cuda",
    "reset_launches",
    "set_dft_precision",
]
