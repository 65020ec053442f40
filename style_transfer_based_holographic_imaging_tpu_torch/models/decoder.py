"""Amplitude/phase decoder (port of the JAX ``models/decoder.py``): relu4_1
features back to a 2-channel (amplitude, phase) image, with the same layer
order and names. The forward takes a compute ``dtype`` (``models/layers.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from style_transfer_based_holographic_imaging_tpu_torch.models.layers import (
    ConvTranspose2x2,
    ReflectConv,
)
from style_transfer_based_holographic_imaging_tpu_torch.models.vgg import scaled

__all__ = ["AmpPhaseDecoder"]

# (name, features, is_upsampler) in forward order; conv10 (the output) follows.
_LAYERS = (
    ("conv0", 512, False),
    ("conv1", 256, False),
    ("up0", 256, True),
    ("conv2", 256, False),
    ("conv3", 256, False),
    ("conv4", 256, False),
    ("conv5", 128, False),
    ("up1", 128, True),
    ("conv6", 128, False),
    ("conv7", 64, False),
    ("up2", 64, True),
    ("conv8", 64, False),
    ("conv9", 64, False),
)


class AmpPhaseDecoder(nn.Module):
    """``(B, C4, H/8, W/8)`` relu4_1 features -> ``(B, 2, H, W)``."""

    def __init__(self, width: float = 1.0, out_channels: int = 2):
        super().__init__()
        c_in = scaled(512, width)
        for name, features, up in _LAYERS:
            c_out = scaled(features, width)
            layer = ConvTranspose2x2(c_in, c_out) if up else ReflectConv(c_in, c_out)
            self.add_module(name, layer)
            c_in = c_out
        self.conv10 = ReflectConv(c_in, out_channels)

    def forward(self, t: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        x = t
        for name, _, _ in _LAYERS:
            x = F.relu(getattr(self, name)(x, dtype))
        return self.conv10(x, dtype)
