"""Distance regressor (port of the JAX ``models/distance.py``): relu4_1
feature statistics -> a normalized distance in (0, 1).

Three Linear -> InstanceNorm -> ReLU blocks and a sigmoid head. With a
``dropout`` generator the forward is the train-mode network of
``TrainConfig.use_dropout``: Dropout(0.5) after each Linear, flax's
(keep where a uniform draw is below 0.5, scaled by 2), its masks drawn from
that generator on the host. Without one (inference, and training by
default) there is none.

The forward takes a compute ``dtype``, as the flax module does. In bf16 the
input, weights and biases are cast to bf16 and every value rounds where XLA
rounds it on the JAX package's jitted path (its fusions, read from the
compiled HLO):

* each product of a layer is summed in fp32 and rounded once to bf16
  (flax ``Dense(dtype=bf16)``), then the bias is added and rounded;
* the instance norm's mean sums the bias add *before* its rounding (XLA
  fuses the add into the reduction), and its variance sums the squares of
  the rounded ``y - mean`` unrounded; each sum is scaled by fp32 ``1/F``
  and rounded, eps is a bf16 constant, and the rsqrt, the product and the
  relu each round;
* the sigmoid is ``1 / (1 + exp(-z))`` with a rounding after the exp, the
  add and the division (``jax.nn.sigmoid`` as XLA expands it).

The fp32 default is the fp32 network as it was.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from style_transfer_based_holographic_imaging_tpu_torch.models.layers import instance_norm_rows

__all__ = ["DistanceMLP"]

_KEEP = 0.5  # 1 - the reference's dropout rate


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
        dropout: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        mean, std = mean_std
        b = mean.shape[0]
        x = torch.cat([mean.reshape(b, -1), std.reshape(b, -1)], dim=-1).to(dtype)
        if dropout is not None and dtype != torch.float32:
            raise ValueError("train-mode dropout runs in float32")
        if dtype == torch.float32:
            for layer in (self.l1, self.l2, self.l3):
                x = layer(x)
                if dropout is not None:
                    keep = torch.rand(x.shape, generator=dropout) < _KEEP
                    x = torch.where(keep.to(x.device), x / _KEEP, 0.0)
                x = F.relu(instance_norm_rows(x))
            return torch.sigmoid(self.out(x))
        for layer in (self.l1, self.l2, self.l3):
            x = _norm_relu(_dense(layer, x), dtype)
        z = _dense(self.out, x).to(dtype).float()
        d = (torch.exp(-z).to(dtype).float() + 1.0).to(dtype).float()
        return (1.0 / d).to(dtype)


def _dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``layer(x)`` below fp32, as fp32 values: the weights cast to ``x``'s
    dtype, the product summed in fp32 and rounded once to it, plus the bias
    in that dtype, the sum not yet rounded."""
    dt = x.dtype
    y = F.linear(x.float(), layer.weight.to(dt).float()).to(dt)
    return y.float() + layer.bias.to(dt).float()


def _norm_relu(y32: torch.Tensor, dt: torch.dtype, eps: float = 1e-5) -> torch.Tensor:
    """relu(instance_norm_rows(y)) in ``dt`` from the unrounded bias add
    ``y32``, rounded where XLA rounds (see the module docstring). Each op
    runs in fp32 and rounds once: torch's own bf16 ``rsqrt`` does not give
    the rounded fp32 rsqrt."""
    inv_n = float(torch.tensor(1.0 / y32.shape[-1], dtype=torch.float32))
    mean = (y32.sum(dim=-1, keepdim=True) * inv_n).to(dt)
    c = (y32.to(dt) - mean).float()
    var = ((c * c).sum(dim=-1, keepdim=True) * inv_n).to(dt)
    var_eps = (var.float() + float(torch.tensor(eps, dtype=dt))).to(dt)
    inv = torch.rsqrt(var_eps.float()).to(dt)
    return F.relu(c.to(dt) * inv)
