"""Layer primitives with the reference's torch semantics, NCHW.

Port of the JAX package's ``models/layers.py``: the reflect-padded 3x3 conv
(the JAX default ``matpad`` backend: materialized reflection pad + VALID
conv), ceil-mode max pooling, the 2x2 stride-2 transposed conv and the
row-wise instance norm of the distance head.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ReflectConv", "max_pool_ceil", "ConvTranspose2x2", "instance_norm_rows"]


class ReflectConv(nn.Conv2d):
    """``ReflectionPad2d(1)`` + VALID 3x3 ``Conv2d``. Weight ``(O, I, 3, 3)``."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 3, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), self.weight, self.bias)


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight, self.bias, stride=2)


def instance_norm_rows(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """torch ``InstanceNorm1d`` on a ``(B, F)`` tensor as the reference runs it:
    each row normalized over its features with the biased variance, no affine."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)
