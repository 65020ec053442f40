"""Distance regressor (port of the JAX ``models/distance.py``): relu4_1
feature statistics -> a normalized distance in (0, 1).

Three Linear -> InstanceNorm -> ReLU blocks and a sigmoid head. With a
``dropout`` generator the forward is the train-mode network of
``TrainConfig.use_dropout``: Dropout(0.5) after each Linear, flax's
(keep where a uniform draw is below 0.5, scaled by 2: ``x / 0.5`` and the
select in the activation's dtype), its masks drawn from that generator on
the host, in fp32 and in bf16 alike. Without one (inference, and training
by default) there is none.

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
  add and the division (``jax.nn.sigmoid`` as XLA expands it). In the
  jitted training step XLA keeps the division in fp32 up to the loss's fp32
  cast (its excess precision: the output reads off the bf16 grid), so the
  training forward asks for it unrounded (``round_output=False``); its
  backward is ``lax.logistic``'s JVP in bf16.

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
        round_output: bool = True,
    ) -> torch.Tensor:
        """``(B, 1)`` in ``dtype``; below fp32 with ``round_output`` off, the
        sigmoid's fp32 quotient (the training step's loss reads that)."""
        mean, std = mean_std
        b = mean.shape[0]
        x = torch.cat([mean.reshape(b, -1), std.reshape(b, -1)], dim=-1).to(dtype)
        if dtype == torch.float32:
            for layer in (self.l1, self.l2, self.l3):
                x = layer(x)
                if dropout is not None:
                    x = _dropout(x, dropout)
                x = F.relu(instance_norm_rows(x))
            return torch.sigmoid(self.out(x))
        for layer in (self.l1, self.l2, self.l3):
            y = _dense(layer, x)
            if dropout is not None:
                # flax's Dropout on the rounded Dense output, in the dtype
                y = _dropout(y.to(dtype), dropout).float()
            x = _norm_relu(y, dtype)
        return _Sigmoid.apply(_dense(self.out, x).to(dtype), round_output)


class _Sigmoid(torch.autograd.Function):
    """``jax.nn.sigmoid`` below fp32 (see the module docstring). Forward
    ``1 / (1 + exp(-z))``, rounded after the exp and the add and, with
    ``round_output``, after the division; without it the fp32 quotient.
    Backward the JVP of
    ``lax.logistic``, ``g * (s * (1 - s))`` with ``s`` rounded, in ``z``'s
    dtype, each op rounded, as the JAX package's jitted step takes it."""

    @staticmethod
    def forward(ctx, z, round_output):
        dt = z.dtype
        d = (torch.exp(-z.float()).to(dt).float() + 1.0).to(dt).float()
        s32 = 1.0 / d
        s = s32.to(dt)
        ctx.save_for_backward(s)
        return s if round_output else s32

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return (g.to(s.dtype) * (s * (1.0 - s))).to(g.dtype), None


def _dropout(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's ``Dropout(0.5)`` in train mode: keep where a uniform draw from
    ``generator`` (on the host) is below 0.5, ``x / 0.5`` there, else zero,
    in ``x``'s dtype."""
    keep = torch.rand(x.shape, generator=generator) < _KEEP
    return torch.where(keep.to(x.device), x / _KEEP, torch.zeros((), dtype=x.dtype, device=x.device))


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
