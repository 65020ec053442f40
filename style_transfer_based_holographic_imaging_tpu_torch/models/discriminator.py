"""PatchGAN discriminator (port of the JAX ``models/discriminator.py``).

A ladder of 4x4 stride-2 pad-1 convs with leaky ReLU 0.01, then two heads
without bias: ``head_src`` (3x3, pad 1), the patch realism map, and
``head_cls`` (k x k VALID, k = image_size / 2^repeat_num), the domain
classifier. Training only (the adversarial term). Module names match the
JAX parameter names, so ``interop.convert_params`` carries a tree across.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["PatchDiscriminator"]


class PatchDiscriminator(nn.Module):
    """``(B, 1, S, S)`` -> (``out_src`` ``(B, 1, S/2^r, S/2^r)``, ``out_cls`` ``(B, c_dim)``)."""

    def __init__(self, image_size: int = 128, conv_dim: int = 64, c_dim: int = 5,
                 repeat_num: int = 6):
        super().__init__()
        self.conv_in = nn.Conv2d(1, conv_dim, 4, stride=2, padding=1)
        dim = conv_dim
        for i in range(1, repeat_num):
            self.add_module(f"conv_{i}", nn.Conv2d(dim, 2 * dim, 4, stride=2, padding=1))
            dim *= 2
        self.repeat_num = repeat_num
        k = image_size // (2**repeat_num)
        self.head_src = nn.Conv2d(dim, 1, 3, padding=1, bias=False)
        self.head_cls = nn.Conv2d(dim, c_dim, k, bias=False)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = F.leaky_relu(self.conv_in(x), 0.01)
        for i in range(1, self.repeat_num):
            x = F.leaky_relu(getattr(self, f"conv_{i}")(x), 0.01)
        out_cls = self.head_cls(x)
        return self.head_src(x), out_cls.reshape(out_cls.shape[0], -1)
