"""Grayscale VGG-19 encoder up to relu4_1 (port of the JAX ``models/vgg.py``).

A 1x1 stem lifts the one-channel hologram to 3 channels, then reflect-padded
3x3 convs with ceil-mode max pools climb the ``_BLOCKS`` ladder. Module names
match the JAX parameter names, so converted trees load with ``strict=True``.
The forward takes a compute ``dtype`` (``models/layers.py``).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from style_transfer_based_holographic_imaging_tpu_torch.models.layers import (
    ReflectConv,
    call_hooked,
    conv_in_dtype,
    max_pool_ceil,
)

__all__ = ["VggEncoder", "scaled"]

# (name, features, pool_before), grouped by the tap each block ends at.
_BLOCKS: Tuple[Tuple[Tuple[str, int, bool], ...], ...] = (
    (("conv1_1", 64, False),),                                          # relu1_1
    (("conv1_2", 64, False), ("conv2_1", 128, True)),                   # relu2_1
    (("conv2_2", 128, False), ("conv3_1", 256, True)),                  # relu3_1
    (
        ("conv3_2", 256, False),
        ("conv3_3", 256, False),
        ("conv3_4", 256, False),
        ("conv4_1", 512, True),
    ),                                                                  # relu4_1
)


def scaled(features: int, width: float) -> int:
    """Channel count at ``width`` (min 8), as in the JAX package."""
    return max(int(round(features * width)), 8)


class VggEncoder(nn.Module):
    """VGG-19 front end (grayscale stem) exposing the relu{1..4}_1 taps."""

    def __init__(self, width: float = 1.0):
        super().__init__()
        self.width = width
        self.stem = nn.Conv2d(1, 3, kernel_size=1)
        c_in = 3
        for block in _BLOCKS:
            for name, features, _ in block:
                c_out = scaled(features, width)
                self.add_module(name, ReflectConv(c_in, c_out))
                c_in = c_out
        self.out_channels = c_in

    def forward(self, x: torch.Tensor, *, all_taps: bool = False,
                dtype: torch.dtype = torch.float32):
        """``(B, 1, H, W)`` -> relu4_1 features, or all four taps, in ``dtype``."""
        if dtype == torch.float32:
            x = self.stem(x)
        else:
            x = call_hooked(self.stem, lambda v: conv_in_dtype(
                F.conv2d, v, self.stem.weight, self.stem.bias, dtype), x)
        taps: List[torch.Tensor] = []
        for block in _BLOCKS:
            for name, _, pool_before in block:
                if pool_before:
                    x = max_pool_ceil(x, 2, 2)
                x = F.relu(getattr(self, name)(x, dtype))
            taps.append(x)
        return taps if all_taps else taps[-1]
