"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``, built at first use).

Each kernel module keeps a ``LAUNCHES`` count per kernel and a
``reset_launches``: ``asm_cuda`` (the ASM propagator), ``conv_stack`` (the
int8 path's fused head and tail) and ``reflect_border`` (the reflect-conv
border ring).
"""

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
