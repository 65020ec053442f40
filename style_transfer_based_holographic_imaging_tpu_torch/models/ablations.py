"""The reference's ablation model families (port of the JAX
``models/ablations.py``), NCHW.

* ``HoloAutoEncoder``: the U-Net holographic autoencoder baseline. ``CBR``
  blocks (conv or transposed conv, then instance, group or batch norm, then
  (leaky) ReLU), a 5-stage double-conv ``HoloEncoder`` (7x7 then 3x3,
  widths 64..1024, 2x2 max pools between stages, the taps l1..l4 kept for
  the skips) and a ``HoloDecoder`` of bilinear 2x upsampling and ``CBR``
  stages with optional skips and a 1x1 output conv.
* ``TrivialSolutionNet``: the "trivial solution" variant of the field
  retrieval net, encode -> decode -> distance without AdaIN, with an
  ``ECALayer`` (Efficient Channel Attention: a global average pool, a k-tap
  1D conv across the channels without bias, a sigmoid gate) on the relu4_1
  features. Its encoder and decoder are the port's ``VggEncoder`` and
  ``AmpPhaseDecoder``, whose reflect convs honour the border backend
  (``models.layers.set_reflect_backend``): with ``cuda`` each of their 20
  convs launches the ring kernel ``holostyle::border_lines``.

The blocks compute what the flax modules compute, not what torch's layers of
the same name do:

* ``padding="SAME"`` is flax's: at stride s a conv pads ``k - 1`` in total
  when ``s`` divides the size, ``(k - 1) // 2`` before, so a stride-2 3x3
  conv on an even input pads (0, 1), not (1, 1). The pads are zeros.
* ``CBR(sampling="up")`` is flax's ``ConvTranspose``: a correlation of the
  zero-inserted input with the *unflipped* kernel, padded as
  ``lax.conv_transpose`` pads ``SAME`` ((2, 1) for k = 3, s = 2).
  ``F.conv_transpose2d`` pads otherwise and flips the kernel.
* Group and batch norm take flax's statistics (``E[x^2] - E[x]^2``, clipped
  at 0) and epsilons (1e-6 and 1e-5); batch norm keeps flax's running
  averages (momentum 0.99, the biased batch variance), which a train-mode
  call (``train=True``, the JAX ``train`` argument; the module's own
  ``training`` flag is not read) updates in place.
* The decoder's upsampling is ``jax.image.resize(..., "bilinear")`` at x2,
  which is ``F.interpolate(..., align_corners=False)``. The reference's
  ``UpsamplingBilinear2d`` aligns the corners; the port follows the JAX
  package.
* The pools are flax's VALID ``max_pool``, ``F.max_pool2d`` in floor mode.

The convs infer their input channels at the first call or state-dict load
(``nn.LazyConv2d``), as flax infers them at ``init``: the constructors take
the JAX modules' arguments and no more. Everything runs in fp32, as the JAX
modules do by default.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from style_transfer_based_holographic_imaging_tpu_torch.models.decoder import AmpPhaseDecoder
from style_transfer_based_holographic_imaging_tpu_torch.models.distance import DistanceMLP
from style_transfer_based_holographic_imaging_tpu_torch.models.vgg import VggEncoder
from style_transfer_based_holographic_imaging_tpu_torch.ops.stats import calc_mean_std

__all__ = [
    "CBR",
    "HoloEncoder",
    "HoloDecoder",
    "HoloAutoEncoder",
    "ECALayer",
    "TrivialSolutionNet",
]

_NORMS = ("instance", "group", "batch", "none")
# flax's defaults: GroupNorm's epsilon, BatchNorm's epsilon and momentum.
_GROUP_EPS = 1e-6
_BATCH_EPS = 1e-5
_BATCH_MOMENTUM = 0.99


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax ``padding="SAME"`` of a strided conv along one axis: (before, after)."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _transpose_pads(k: int, s: int) -> Tuple[int, int]:
    """``lax.conv_transpose``'s ``SAME`` padding of the zero-inserted input."""
    total = k + s - 2
    before = k - 1 if s > k - 1 else -(-total // 2)
    return before, total - before


def _flax_normalize(x, mean, var, eps, scale, bias):
    """flax's ``_normalize``: ``(x - mean) * (rsqrt(var + eps) * scale) + bias``."""
    return (x - mean) * (torch.rsqrt(var + eps) * scale) + bias


def _fast_stats(x: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """flax's ``_compute_stats``: the mean and ``max(0, E[x^2] - E[x]^2)``."""
    mean = x.mean(dim=dims, keepdim=True)
    var = torch.clamp((x * x).mean(dim=dims, keepdim=True) - mean * mean, min=0.0)
    return mean, var


class _GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups)``: statistics over (channels of the
    group, H, W), epsilon 1e-6, an affine ``weight`` (flax ``scale``) and
    ``bias``."""

    def __init__(self, num_groups: int, channels: int):
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        mean, var = _fast_stats(x.reshape(b, self.num_groups, c // self.num_groups, h, w), (2, 3, 4))
        rep = lambda t: t.repeat_interleave(c // self.num_groups, dim=1).reshape(b, c, 1, 1)  # noqa: E731
        return _flax_normalize(x, rep(mean), rep(var), _GROUP_EPS, self.weight.view(1, -1, 1, 1),
                               self.bias.view(1, -1, 1, 1))


class _BatchNorm(nn.Module):
    """flax ``nn.BatchNorm``: in train mode the batch's statistics over
    (N, H, W), and the running averages ``ra = 0.99 ra + 0.01 batch`` (the
    biased variance); in eval mode the running averages. Epsilon 1e-5, an
    affine ``weight`` (flax ``scale``) and ``bias``; the running averages
    are the buffers ``running_mean`` and ``running_var`` (flax's
    ``batch_stats`` ``mean`` and ``var``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if train:
            mean, var = _fast_stats(x, (0, 2, 3))
            with torch.no_grad():
                m = _BATCH_MOMENTUM
                self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean.reshape(-1))
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var.reshape(-1))
        else:
            mean, var = self.running_mean.view(1, -1, 1, 1), self.running_var.view(1, -1, 1, 1)
        return _flax_normalize(x, mean, var, _BATCH_EPS, self.weight.view(1, -1, 1, 1),
                               self.bias.view(1, -1, 1, 1))


class CBR(nn.Module):
    """Conv (or transposed conv) + norm + (leaky) ReLU (the reference's
    ``CBR``). ``conv.weight`` is ``(O, I, k, k)``; for ``sampling="up"`` it
    is flax's transposed-conv kernel ``(k, k, I, O)`` as OIHW, unflipped."""

    def __init__(self, features: int, kernel: int = 3, stride: int = 1, norm: str = "instance",
                 lrelu: bool = False, slope: float = 0.2, sampling: str = "down"):
        super().__init__()
        if norm not in _NORMS:
            raise ValueError(f"unknown norm {norm!r}: one of {_NORMS}")
        if sampling not in ("down", "up"):
            raise ValueError(f"unknown sampling {sampling!r}: down or up")
        self.kernel, self.stride = kernel, stride
        self.norm_kind, self.lrelu, self.slope, self.sampling = norm, lrelu, slope, sampling
        # the up-conv's correlation runs at stride 1 over the zero-inserted input
        self.conv = nn.LazyConv2d(features, kernel, stride=1 if sampling == "up" else stride)
        if norm == "group":
            self.norm = _GroupNorm(min(16, features), features)
        elif norm == "batch":
            self.norm = _BatchNorm(features)

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel, self.stride
        if self.sampling == "up":
            b, c, h, w = x.shape
            if s > 1:
                z = x.new_zeros(b, c, (h - 1) * s + 1, (w - 1) * s + 1)
                z[:, :, ::s, ::s] = x
                x = z
            lo, hi = _transpose_pads(k, s)
            return self.conv(F.pad(x, (lo, hi, lo, hi)))
        top, bottom = _same_pads(x.shape[-2], k, s)
        left, right = _same_pads(x.shape[-1], k, s)
        return self.conv(F.pad(x, (left, right, top, bottom)))

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        x = self._conv(x)
        if self.norm_kind == "instance":
            # per sample and channel over H, W; the biased variance, no affine
            mean = x.mean(dim=(2, 3), keepdim=True)
            var = ((x - mean) ** 2).mean(dim=(2, 3), keepdim=True)
            x = (x - mean) * torch.rsqrt(var + 1e-5)
        elif self.norm_kind == "group":
            x = self.norm(x)
        elif self.norm_kind == "batch":
            x = self.norm(x, train)
        return F.leaky_relu(x, self.slope) if self.lrelu else F.relu(x)


class HoloEncoder(nn.Module):
    """Five double-conv stages (7x7 then 3x3 first, ``base * 2**i``
    features), 2x2 max pools between them. Returns the latent ``(B, 16 base,
    H/16, W/16)`` and the taps l1..l4."""

    def __init__(self, base: int = 64, norm: str = "instance"):
        super().__init__()
        for i in range(5):
            w = base * 2**i
            self.add_module(f"l{i + 1}0", CBR(w, kernel=7 if i == 0 else 3, norm=norm))
            self.add_module(f"l{i + 1}1", CBR(w, kernel=3, norm=norm))

    def forward(self, x: torch.Tensor, *, train: bool = False) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        taps = []
        for i in range(5):
            if i > 0:
                x = F.max_pool2d(x, 2, 2)
            x = getattr(self, f"l{i + 1}0")(x, train=train)
            x = getattr(self, f"l{i + 1}1")(x, train=train)
            if i < 4:
                taps.append(x)
        return x, taps


class HoloDecoder(nn.Module):
    """Four stages of bilinear x2 upsampling, the matching tap concatenated
    after the upsampled channels (``skip``), and two 3x3 ``CBR``s of
    ``base * 2**i`` features (8 base .. base); a 1x1 output conv with bias."""

    def __init__(self, out_channels: int = 2, base: int = 64, skip: bool = True, norm: str = "instance"):
        super().__init__()
        self.skip = skip
        for i in range(4):
            w = base * 2 ** (3 - i)
            self.add_module(f"up{i + 1}0", CBR(w, kernel=3, norm=norm))
            self.add_module(f"up{i + 1}1", CBR(w, kernel=3, norm=norm))
        self.conv_out = nn.LazyConv2d(out_channels, 1)

    def forward(self, latent: torch.Tensor, taps: List[torch.Tensor], *, train: bool = False) -> torch.Tensor:
        x = latent
        for i in range(4):
            x = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
            if self.skip:
                x = torch.cat([x, taps[-(i + 1)]], dim=1)
            x = getattr(self, f"up{i + 1}0")(x, train=train)
            x = getattr(self, f"up{i + 1}1")(x, train=train)
        return self.conv_out(x)


class HoloAutoEncoder(nn.Module):
    """Hologram ``(B, C, H, W)`` -> (amplitude, phase) ``(B, out_channels, H,
    W)``, H and W multiples of 16. Its widths are always 64..1024 (the JAX
    module passes no ``base``); ``in_channels`` is read from the input, as
    in the JAX module, which declares it and does not use it."""

    def __init__(self, in_channels: int = 1, out_channels: int = 2, skip: bool = True, norm: str = "instance"):
        super().__init__()
        self.in_channels = in_channels
        self.encoder = HoloEncoder(norm=norm)
        self.decoder = HoloDecoder(out_channels=out_channels, skip=skip, norm=norm)

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        latent, taps = self.encoder(x, train=train)
        return self.decoder(latent, taps, train=train)


class ECALayer(nn.Module):
    """Efficient Channel Attention on ``(B, C, H, W)``: the mean over H, W,
    a ``k_size``-tap conv along the channels (zero SAME pad, no bias;
    ``conv.weight`` ``(1, 1, k)`` is flax's ``(k, 1, 1)`` kernel, unflipped),
    a sigmoid, the input gated channel by channel."""

    def __init__(self, k_size: int = 3):
        super().__init__()
        self.k_size = k_size
        self.conv = nn.Conv1d(1, 1, k_size, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.mean(dim=(2, 3))[:, None, :]                      # (B, 1, C)
        k = self.k_size
        y = self.conv(F.pad(y, ((k - 1) // 2, k // 2)))[:, 0]    # (B, C)
        return x * torch.sigmoid(y)[:, :, None, None]


class TrivialSolutionNet(nn.Module):
    """Encode -> (ECA) -> decode, and the distance from the gated features'
    statistics: ``(B, 1, H, W)`` -> (amp, phase) ``(B, 1, H, W)`` each and
    the distance ``(B, 1)``. No AdaIN; the distance head has no dropout (the
    JAX module's ``dropout_rate=0.0``). Width 1.0, fp32."""

    def __init__(self, use_eca: bool = True):
        super().__init__()
        self.use_eca = use_eca
        self.encoder = VggEncoder()
        self.decoder = AmpPhaseDecoder()
        self.distance_g = DistanceMLP(self.encoder.out_channels)
        if use_eca:
            self.eca = ECALayer()

    def forward(self, content: torch.Tensor):
        feat = self.encoder(content)
        if self.use_eca:
            feat = self.eca(feat)
        out = self.decoder(feat)
        return out[:, 0:1], out[:, 1:2], self.distance_g(calc_mean_std(feat))
