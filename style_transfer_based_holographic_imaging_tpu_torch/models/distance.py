"""Distance regressor (port of the JAX ``models/distance.py``): relu4_1
feature statistics -> a normalized distance in (0, 1).

Three Linear -> InstanceNorm -> ReLU blocks and a sigmoid head. This is the
eval-mode network: the reference's Dropout(0.5) is off at inference, so the
forward has none.

The forward takes a compute ``dtype``, as the flax module does. In bf16 the
input, weights and biases are cast to bf16, each product of a layer is taken
with fp32 accumulation and rounded once to bf16 (flax ``Dense(dtype=bf16)``
on XLA), the bias is added in bf16, and the instance norm, relu and sigmoid
run in bf16. The fp32 default is the fp32 network as it was.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from style_transfer_based_holographic_imaging_tpu_torch.models.layers import instance_norm_rows

__all__ = ["DistanceMLP"]


class DistanceMLP(nn.Module):
    """``(mean, std)`` of ``in_channels`` features each -> ``(B, 1)``."""

    def __init__(self, in_channels: int = 512, hidden: int = 1024):
        super().__init__()
        self.l1 = nn.Linear(2 * in_channels, hidden)
        self.l2 = nn.Linear(hidden, hidden)
        self.l3 = nn.Linear(hidden, hidden // 2)
        self.out = nn.Linear(hidden // 2, 1)

    def forward(
        self,
        mean_std: Tuple[torch.Tensor, torch.Tensor],
        *,
        dtype: torch.dtype = torch.float32,
    ) -> torch.Tensor:
        mean, std = mean_std
        b = mean.shape[0]
        x = torch.cat([mean.reshape(b, -1), std.reshape(b, -1)], dim=-1).to(dtype)
        for layer in (self.l1, self.l2, self.l3):
            x = F.relu(instance_norm_rows(_dense(layer, x)))
        return torch.sigmoid(_dense(self.out, x))


def _dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)`` in ``x``'s dtype: below fp32, the weights cast to it, the
    product summed in fp32 and rounded once, then the bias added."""
    if x.dtype == torch.float32:
        return layer(x)
    y = F.linear(x.float(), layer.weight.to(x.dtype).float()).to(x.dtype)
    return y + layer.bias.to(x.dtype)
