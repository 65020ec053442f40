"""Layer primitives with the reference's torch semantics, NCHW.

Port of the JAX package's ``models/layers.py``: the reflect-padded 3x3 conv
with its border backends, ceil-mode max pooling, the 2x2 stride-2 transposed
conv and the row-wise instance norm of the distance head.

The convs take a compute ``dtype`` per call, as the flax modules do: the
parameters stay fp32 and are cast to it at each conv with the activation
and the bias (``conv_in_dtype``). Every dtype honours the border backend,
as the JAX package's ``ReflectConv`` does: below fp32 the ring backends run
the SAME conv in that dtype and the ring from the edge lines in it (the
kernel folds the taps and sums in fp32 and rounds once, as the plain
version and the JAX einsum do).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from style_transfer_based_holographic_imaging_tpu_torch.kernels import reflect_border

__all__ = [
    "ReflectConv",
    "max_pool_ceil",
    "ConvTranspose2x2",
    "instance_norm_rows",
    "set_reflect_backend",
    "conv_in_dtype",
    "at_least_fp32",
]

# Border handling of ReflectConv, the JAX package's backends: "matpad"
# (materialize the reflection pad, VALID conv), "einsum" (SAME conv, then
# the one-pixel border ring recomputed from the edge lines with tensor ops),
# "cuda" (the same ring from the Hopper kernel of kernels/reflect_border.py,
# the op ``holostyle::border_lines`` with its backward; the JAX package's
# "pallas") or "auto", which is "matpad" as in the JAX package.
_REFLECT_BACKENDS = ("auto", "matpad", "einsum", "cuda")
_REFLECT_BACKEND = "auto"


def set_reflect_backend(backend: str) -> None:
    """Border backend of every ReflectConv: auto, matpad, einsum or cuda."""
    global _REFLECT_BACKEND
    if backend not in _REFLECT_BACKENDS:
        raise ValueError(f"unknown reflect backend {backend!r}")
    _REFLECT_BACKEND = backend


def at_least_fp32(x: torch.Tensor) -> torch.Tensor:
    """``x`` cast up to fp32 when its float type is narrower (bf16, the
    mixed-precision compute dtype); fp32 and float64 stay as they are."""
    return x.float() if x.is_floating_point() and x.element_size() < 4 else x


def conv_in_dtype(op, x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                  dt: torch.dtype, **kw) -> torch.Tensor:
    """``op(x, kernel) + bias`` in ``dt``: the operands cast to ``dt``, the
    products summed in fp32 and rounded once to ``dt`` (XLA's bf16 conv),
    then the bias added in ``dt``. On the card the conv is cuDNN's in
    ``dt`` (tensor cores, fp32 accumulation, one rounding); on the CPU the
    rounded operands go through the fp32 conv, the same rule, which the CPU
    tests hold bit for bit. In fp32 the casts are no-ops."""
    if x.is_cuda:
        y = op(x.to(dt), kernel.to(dt), **kw)
    else:
        y = op(x.to(dt).float(), kernel.to(dt).float(), **kw).to(dt)
    return y + bias.to(dt).view(1, -1, 1, 1)


class ReflectConv(nn.Conv2d):
    """``ReflectionPad2d(1)`` + VALID 3x3 ``Conv2d``. Weight ``(O, I, 3, 3)``."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 3, padding=0)

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        backend = "matpad" if _REFLECT_BACKEND == "auto" else _REFLECT_BACKEND
        h, w = x.shape[-2], x.shape[-1]
        low = dtype != torch.float32
        if backend == "matpad" or h < 4 or w < 4:
            if low:
                xp = F.pad(x.to(dtype), (1, 1, 1, 1), mode="reflect")
                return conv_in_dtype(F.conv2d, xp, self.weight, self.bias, dtype)
            return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), self.weight, self.bias)
        ring = reflect_border.border_lines if backend == "cuda" else reflect_border.border_lines_plain
        if low:
            x, weight = x.to(dtype), self.weight.to(dtype)
            bias = self.bias.to(dtype).view(1, -1, 1)
            y = conv_in_dtype(F.conv2d, x, self.weight, self.bias, dtype, padding=1)
        else:
            weight, bias = self.weight, self.bias.view(1, -1, 1)
            y = F.conv2d(x, weight, padding=1) + bias[..., None]
        rows, cols = ring(x.contiguous(), weight)
        y[:, :, 0] = rows[:, :, 0] + bias
        y[:, :, h - 1] = rows[:, :, 1] + bias
        y[:, :, 1 : h - 1, 0] = cols[:, :, 1 : h - 1, 0] + bias
        y[:, :, 1 : h - 1, w - 1] = cols[:, :, 1 : h - 1, 1] + bias
        return y


def max_pool_ceil(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    """Max pool with ``ceil_mode=True``: partial windows at the edge are kept."""
    return F.max_pool2d(x, window, stride, ceil_mode=True)


class ConvTranspose2x2(nn.Module):
    """``ConvTranspose2d(C_in, C_out, 2, stride=2)``:
    ``y[b, o, 2i+di, 2j+dj] = sum_c x[b, c, i, j] W[c, o, di, dj] + bias[o]``,
    with the kernel in torch's native ``(C_in, C_out, 2, 2)`` layout (the
    layout the JAX package stores)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_channels, out_channels, 2, 2))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        nn.init.normal_(self.weight, std=in_channels**-0.5)

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        if dtype != torch.float32:
            return conv_in_dtype(F.conv_transpose2d, x, self.weight, self.bias, dtype, stride=2)
        return F.conv_transpose2d(x, self.weight, self.bias, stride=2)


def instance_norm_rows(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """torch ``InstanceNorm1d`` on a ``(B, F)`` tensor as the reference runs it:
    each row normalized over its features with the biased variance, no affine.
    The means are summed in fp32 and rounded to ``x``'s dtype (``jnp.mean``)."""
    dt = x.dtype
    mean = x.float().mean(dim=-1, keepdim=True).to(dt)
    var = ((x - mean) ** 2).float().mean(dim=-1, keepdim=True).to(dt)
    return (x - mean) * torch.rsqrt(var + eps)
