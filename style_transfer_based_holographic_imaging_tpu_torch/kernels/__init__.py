"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``, built at first use).

Each kernel module keeps a ``LAUNCHES`` count per kernel and a
``reset_launches``: ``asm_cuda`` (the ASM propagator), ``conv_stack`` (the
int8 path's fused head and tail), ``halo_conv`` (the decoder tail in row
blocks with a halo) and ``reflect_border`` (the reflect-conv border ring).
Each registers its kernels as ``holostyle::`` custom ops (``library``):
importing this package registers all seven.
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
from style_transfer_based_holographic_imaging_tpu_torch.kernels import (  # noqa: F401  (registers the ops)
    conv_stack,
    halo_conv,
    reflect_border,
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
