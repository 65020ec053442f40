"""Halo row-block decoder tail: Hopper kernels, wrappers, plain versions.

Two kernels of ``csrc/halo_conv.cu``, built by ``_build`` with ``nvcc`` and
called through ``ctypes``, replace the JAX package's kernels/halo_conv.py:

* ``halo_conv_tail`` (``_halo_kernel``): the row blocks' slabs loaded at a
  run-time row offset;
* ``halo_conv_tail_static`` (``_halo_static_kernel``): one block per image
  and column tile walks the row blocks with the block height a compile-time
  constant (``STATIC_BLOCK_ROWS``).

Both compute the decoder tail conv8 -> relu -> conv9 -> relu -> conv10 of
``x`` ``(B, C, H, W)`` in three parts along H:

* rows 0..3 and H-4..H-1 (``EDGE`` = 4) from 10-row strips through
  ``conv_stack.conv_tail_reference``, with true per-layer reflect padding in
  H and W and the reference's two roundings per layer in bf16; only the
  strip's first (top) or last (bottom) 4 rows are kept;
* the interior rows 4..H-5 in row blocks of ``bh`` rows, ``(H - 8) % bh ==
  0``: block i reads input rows ``4 + i*bh - 3 .. 4 + i*bh + bh + 2`` and
  runs the three convs VALID in H (bh+4, bh+2, bh rows) and reflect-padded
  in W at every layer, with fp32 products and sums and the fp32 bias before
  the one rounding to x's dtype (``_tail_block``'s arithmetic). Every row
  they read is a real row, so this is the reflect-padded tail on those
  rows, in the fused tail's numerics.

Inputs are NCHW in fp32 or bf16, kernels OIHW in x's dtype, biases fp32, as
``conv_stack.fused_conv_tail`` takes them. The kernels run the fused tail's
tile body: on the tensor cores in bf16 (weights packed by
``conv_stack.pack_tc_weights``), on the CUDA cores in fp32. Arguments are
checked before any launch. Each kernel's interior is a custom op
(``holostyle::halo_interior``, ``holostyle::halo_interior_static``;
``library``): for a tensor on the CPU its plain version; for a CUDA tensor
the kernel's launch or an error, never a fallback. The strips run the same
on both devices.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from style_transfer_based_holographic_imaging_tpu_torch.kernels import _build, conv_stack, library

__all__ = [
    "halo_conv_tail",
    "halo_conv_tail_static",
    "halo_conv_tail_plain",
    "halo_interior",
    "halo_interior_plain",
    "EDGE",
    "STATIC_BLOCK_ROWS",
    "LAUNCHES",
    "reset_launches",
]

HALO = 3    # one row per conv of the chain
EDGE = 4    # top and bottom rows taken from the strips
STRIP = EDGE + 2 * HALO  # input rows of a strip: its far edge never reaches a kept row
# Block heights the static kernel is instantiated for (csrc/halo_conv.cu).
STATIC_BLOCK_ROWS = (8, 16, 24, 30, 60)

# Launches of each kernel by its wrapper.
LAUNCHES = {"halo_conv_tail": 0, "halo_conv_tail_static": 0}

_SOURCE = "halo_conv"


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(x: torch.Tensor, layers, bh, static: bool) -> None:
    conv_stack.check_stack(x, layers)
    h, w = x.shape[-2:]
    if h < STRIP:
        raise ValueError(f"the halo tail needs H >= {STRIP}, got {h}")
    if w < 2:
        raise ValueError(f"the halo tail needs W >= 2, got {w}")
    if not isinstance(bh, int) or bh < 1 or (h - 2 * EDGE) % bh:
        raise ValueError(f"bh must be a positive divisor of H - {2 * EDGE} = {h - 2 * EDGE}, got {bh!r}")
    if static and bh not in STATIC_BLOCK_ROWS:
        raise ValueError(f"the static kernel is built for bh in {STATIC_BLOCK_ROWS}, got {bh}")


def _valid_h_conv(x, k, b, relu: bool):
    """One layer of ``_tail_block``: VALID in H, ReflectionPad2d(1) in W,
    fp32 products and sums, the fp32 bias, the relu, one rounding."""
    xp = F.pad(x.float(), (1, 1, 0, 0), mode="reflect")
    y = F.conv2d(xp, k.float()) + b.float().view(1, -1, 1, 1)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def halo_interior_plain(x, k8, b8, k9, b9, k10, b10, *, bh: int = 30):
    """The interior rows 4..H-5, ``(B, O10, H - 8, W)``, row block by row
    block in ``_tail_block``'s arithmetic (plain version of the kernels)."""
    blocks = []
    for start in range(EDGE - HALO, x.shape[2] - EDGE - HALO - bh + 1, bh):
        y = x[:, :, start : start + bh + 2 * HALO]
        y = _valid_h_conv(y, k8, b8, relu=True)
        y = _valid_h_conv(y, k9, b9, relu=True)
        blocks.append(_valid_h_conv(y, k10, b10, relu=False))
    return torch.cat(blocks, dim=2)


def _with_edges(x, interior, k8, b8, k9, b9, k10, b10):
    """The interior between the top and bottom 4 rows of the strips."""
    weights = (k8, b8, k9, b9, k10, b10)
    h = x.shape[2]
    top = conv_stack.conv_tail_reference(x[:, :, :STRIP], *weights)[:, :, :EDGE]
    bottom = conv_stack.conv_tail_reference(x[:, :, h - STRIP :], *weights)[:, :, -EDGE:]
    return torch.cat([top, interior, bottom], dim=2)


def halo_conv_tail_plain(x, k8, b8, k9, b9, k10, b10, *, bh: int = 30):
    """conv8/relu/conv9/relu/conv10 of ``x`` as the halo tail computes it
    (plain version): ``(B, O10, H, W)`` in x's dtype."""
    layers = ((k8, b8), (k9, b9), (k10, b10))
    _check(x, layers, bh, static=False)
    interior = halo_interior_plain(x, k8, b8, k9, b9, k10, b10, bh=bh)
    return _with_edges(x, interior, k8, b8, k9, b9, k10, b10)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.halo_tail, lib.halo_tail_static):
        fn.argtypes = [i, p, i, i, i, i, i] + [p, p, i] * 3 + [p, p]
        fn.restype = ctypes.c_int
    return lib


def _interior_cpu(x: torch.Tensor, k8: torch.Tensor, b8: torch.Tensor, k9: torch.Tensor,
                  b9: torch.Tensor, k10: torch.Tensor, b10: torch.Tensor, bh: int) -> torch.Tensor:
    return halo_interior_plain(x, k8, b8, k9, b9, k10, b10, bh=bh)


def _interior_cuda(name: str, entry: str):
    def run(x, k8, b8, k9, b9, k10, b10, bh):
        b, _, h, w = x.shape
        out = torch.empty(b, k10.shape[0], h - 2 * EDGE, w, dtype=x.dtype, device=x.device)
        return conv_stack.launch(LAUNCHES, name, getattr(_lib(), entry), x,
                                 ((k8, b8), (k9, b9), (k10, b10)), out, bh,
                                 tc_tiles=conv_stack.TC_N_TILES)
    return run


def _interior_fake(x, k8, b8, k9, b9, k10, b10, bh):
    b, _, h, w = x.shape
    return x.new_empty(b, k10.shape[0], h - 2 * EDGE, w)


# The interior rows, the part of the tail each kernel computes.
_INTERIOR = {
    False: library.kernel_op("halo_interior", _interior_cpu,
                             _interior_cuda("halo_conv_tail", "halo_tail"), _interior_fake),
    True: library.kernel_op("halo_interior_static", _interior_cpu,
                            _interior_cuda("halo_conv_tail_static", "halo_tail_static"),
                            _interior_fake),
}


def halo_interior(x, k8, b8, k9, b9, k10, b10, *, bh: int = 30, static: bool = False):
    """The interior rows 4..H-5 of the tail, ``(B, O10, H - 8, W)``: the op
    ``holostyle::halo_interior`` (with ``static``,
    ``holostyle::halo_interior_static``), one launch of the dynamic (or the
    static) kernel for a CUDA tensor, the plain version for a CPU tensor."""
    _check(x, ((k8, b8), (k9, b9), (k10, b10)), bh, static)
    return _INTERIOR[static](x, k8, b8, k9, b9, k10, b10, bh)


def halo_conv_tail(x, k8, b8, k9, b9, k10, b10, *, bh: int = 30):
    """conv8/relu/conv9/relu/conv10 of ``x`` ``(B, C, H, W)`` via row blocks
    of ``bh`` rows with a 3-row halo, loaded at a run-time row offset:
    ``(B, O10, H, W)`` in x's dtype."""
    interior = halo_interior(x, k8, b8, k9, b9, k10, b10, bh=bh)
    return _with_edges(x, interior, k8, b8, k9, b9, k10, b10)


def halo_conv_tail_static(x, k8, b8, k9, b9, k10, b10, *, bh: int = 30):
    """:func:`halo_conv_tail` with one block per image and column tile
    walking the row blocks, ``bh`` a compile-time constant of the kernel:
    one of ``STATIC_BLOCK_ROWS``, on either device."""
    interior = halo_interior(x, k8, b8, k9, b9, k10, b10, bh=bh, static=True)
    return _with_edges(x, interior, k8, b8, k9, b9, k10, b10)
