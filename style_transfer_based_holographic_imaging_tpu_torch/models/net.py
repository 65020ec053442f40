"""The combined field-retrieval network (port of the JAX ``models/net.py``).

VGG encoder + AdaIN against a stored style vector + amplitude/phase decoder
+ distance regressor. ``field_retrieval`` is the inference path;
``forward`` is the training forward (the JAX ``__call__``) with its
content and style losses, in fp32 or, for mixed-precision training, bf16; ``init_net_params`` draws a fresh state dict
with the flax initializers' distributions.

``field_retrieval`` takes the compute ``dtype`` per call, as the flax module
takes it: the parameters stay fp32 and every conv, transposed conv and
dense layer casts them, the activation and the bias to it. bf16 is the fp
net that ``cli serve`` serves by default; its roundings are those of the
int8 path's fp layers
(``models/layers.conv_in_dtype``, the distance head and the feature
statistics in ``models/distance.py`` and ``ops/stats.py``).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from style_transfer_based_holographic_imaging_tpu_torch.models.decoder import AmpPhaseDecoder
from style_transfer_based_holographic_imaging_tpu_torch.models.distance import DistanceMLP
from style_transfer_based_holographic_imaging_tpu_torch.models.layers import at_least_fp32
from style_transfer_based_holographic_imaging_tpu_torch.models.vgg import VggEncoder
from style_transfer_based_holographic_imaging_tpu_torch.ops.stats import (
    adain,
    adain_with_stats,
    calc_mean_std,
)

__all__ = ["StyleTransferNet", "split_style_vector", "has_phase_decoder", "style_stats_nchw",
           "init_net_params", "init_params"]

_DTYPES = (torch.float32, torch.bfloat16)


def _check_dtype(dtype: torch.dtype) -> torch.dtype:
    if dtype not in _DTYPES:
        raise ValueError(f"unsupported compute dtype {dtype}: float32 or bfloat16")
    return dtype


def has_phase_decoder(params: Mapping) -> bool:
    """True iff a parameter tree (JAX nested dict, optionally under
    ``'params'``) or a port state dict carries a ``decoder_ph`` head."""
    inner = params.get("params", params)
    return any(k == "decoder_ph" or str(k).startswith("decoder_ph.") for k in inner)


def split_style_vector(style_vector) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split a stored ``(2n, C, 1, 1)`` or ``(2n, 1, 1, C)`` style vector into
    NCHW-broadcastable ``(n, C, 1, 1)`` (mean, std): first half means, second
    half stds."""
    sv = torch.as_tensor(style_vector, dtype=torch.float32)
    if sv.ndim != 4:
        raise ValueError(f"style vector must be 4D, got {tuple(sv.shape)}")
    sv = style_stats_nchw(sv)
    half = sv.shape[0] // 2
    return sv[:half], sv[half:]


def style_stats_nchw(x: torch.Tensor) -> torch.Tensor:
    """Style statistics in the JAX package's NHWC ``(n, 1, 1, C)`` layout ->
    NCHW ``(n, C, 1, 1)``; NCHW input passes through."""
    if x.ndim == 4 and x.shape[1] == 1 and x.shape[2] == 1 and x.shape[3] != 1:
        return x.permute(0, 3, 1, 2)
    return x


class StyleTransferNet(nn.Module):
    """VGG encoder + AdaIN + amp/phase decoder + distance regressor."""

    def __init__(self, width: float = 1.0, with_phase_decoder: bool = False):
        super().__init__()
        self.width = width
        self.with_phase_decoder = with_phase_decoder
        self.encoder = VggEncoder(width=width)
        self.decoder = AmpPhaseDecoder(width=width)
        if with_phase_decoder:
            self.decoder_ph = AmpPhaseDecoder(width=width)
        self.distance_g = DistanceMLP(self.encoder.out_channels)

    @classmethod
    def from_state_dict(cls, state: Mapping[str, torch.Tensor],
                        width: float) -> "StyleTransferNet":
        """The net of a release's state dict (``interop.load_release_weights``
        or ``convert_params``) at the width of its ``config.json``, loaded
        with ``strict=True``, in eval mode, on the CPU."""
        net = cls(width=width, with_phase_decoder=has_phase_decoder(state))
        net.load_state_dict(state, strict=True)
        return net.eval()

    def encode(self, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return self.encoder(x, dtype=dtype)

    def encode_with_intermediate(self, x: torch.Tensor):
        """The relu1_1, relu2_1, relu3_1 and relu4_1 taps, fp32."""
        return self.encoder(x, all_taps=True)

    def forward(
        self,
        content: torch.Tensor,
        style: torch.Tensor,
        alpha: float = 1.0,
        *,
        dropout: Optional[torch.Generator] = None,
        dtype: torch.dtype = torch.float32,
    ) -> Dict[str, torch.Tensor]:
        """The training forward (the JAX ``__call__`` with ``field_retrieval``
        and ``unknown_distance``). ``content`` and ``style`` are
        sqrt-intensity holograms ``(B, 1, H, W)``. Returns ``loss_content``,
        ``loss_style``, ``g_t`` and ``g_t_phase`` ``(B, 1, H, W)``, ``t``
        and the distances ``d_content``, ``d_style`` ``(B, 1)``; ``dropout``
        is the distance head's train-mode generator. The encoders, AdaIN,
        the decoder(s) and the distance head run in the compute ``dtype``
        (their outputs stay in it, but for the distances: below fp32 the
        sigmoid's unrounded fp32 quotient, which the JAX package's jitted
        step feeds its loss); the two losses are taken in fp32 from
        fp32 copies of the features, as the JAX package takes them. The JAX
        ``__call__``'s ``style_re`` (a decoder pass over the style features)
        is left out: no loss reads it, and under ``jit`` the JAX package
        drops it too."""
        dt = _check_dtype(dtype)
        style_feats = self.encoder(style, all_taps=True, dtype=dt)
        content_feat = self.encode(content, dt)
        t = adain(content_feat, style_feats[-1])
        t = alpha * t + (1.0 - alpha) * content_feat

        g = self.decoder(t, dt)
        g_t, g_t_phase = g[:, 0:1], g[:, 1:2]
        if self.with_phase_decoder:
            g_t_phase = self.decoder_ph(t, dt)[:, 0:1]
        g_t_feats = self.encoder(g_t, all_taps=True, dtype=dt)

        up = at_least_fp32
        loss_c = torch.mean((up(g_t_feats[-1]) - up(t.detach())) ** 2)
        loss_s = torch.zeros((), dtype=torch.float32, device=g_t.device)
        for gf, sf in zip(g_t_feats, style_feats):
            gm, gs = calc_mean_std(up(gf))
            sm, ss = calc_mean_std(up(sf.detach()))
            loss_s = loss_s + torch.mean((gm - sm) ** 2) + torch.mean((gs - ss) ** 2)
        out = {
            "loss_content": loss_c,
            "loss_style": loss_s,
            "g_t": g_t,
            "g_t_phase": g_t_phase,
            "t": t,
            "d_content": self.distance_g(calc_mean_std(content_feat), dtype=dt, dropout=dropout,
                                         round_output=False),
            "d_style": self.distance_g(calc_mean_std(style_feats[-1]), dtype=dt, dropout=dropout,
                                       round_output=False),
        }
        return out

    def field_retrieval(
        self,
        content: torch.Tensor,
        style_mean: torch.Tensor,
        style_std: torch.Tensor,
        alpha: float = 1.0,
        *,
        unknown_distance: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        """sqrt-intensity hologram ``(B, 1, H, W)`` -> (A_t, phi_t[, d]) at the
        style plane, each ``(B, 1, H, W)`` (d: ``(B, 1)``), in the compute
        ``dtype``. ``style_mean`` / ``style_std`` broadcast against the
        ``(B, C, h, w)`` relu4_1 features."""
        dt = _check_dtype(dtype)
        content_feat = self.encode(content, dt)
        t = adain_with_stats(content_feat, style_mean, style_std)
        t = alpha * t + (1.0 - alpha) * content_feat

        g = self.decoder(t, dt)
        amp, phase = g[:, 0:1], g[:, 1:2]
        if self.with_phase_decoder:
            phase = self.decoder_ph(t, dt)[:, 0:1]
        if unknown_distance:
            d = self.distance_g(calc_mean_std(content_feat), dtype=dt)
            return amp, phase, d
        return amp, phase



# flax's lecun_normal / variance_scaling(1, "fan_in", "truncated_normal"): a
# normal truncated to +/-2 and rescaled to unit variance, times 1/sqrt(fan_in).
_TRUNC_STD = 0.87962566103423978


def _fan_in(name: str, weight: torch.Tensor) -> int:
    """fan_in as flax computes it on the JAX package's kernel layout."""
    if weight.ndim == 2:                         # Dense (in, out): in
        return weight.shape[1]
    if name.split(".")[-2].startswith("up"):     # (C_in, C_out, 2, 2), in_axis -2: 2 C_in C_out
        return weight.shape[2] * weight.shape[0] * weight.shape[1]
    return weight.shape[1] * weight.shape[2] * weight.shape[3]   # OIHW: kh kw C_in


def init_params(module: nn.Module, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """A fresh fp32 state dict of ``module`` on the CPU, with the flax
    defaults' distributions: every kernel a truncated normal of variance
    ``1/fan_in`` (fan_in of the JAX layout), every bias zero. The draws run
    in state-dict order from ``generator``."""
    state = {}
    for name, p in module.state_dict().items():
        t = torch.zeros(p.shape, dtype=torch.float32)
        if name.endswith("weight"):
            torch.nn.init.trunc_normal_(t, std=1.0, a=-2.0, b=2.0, generator=generator)
            t.mul_(1.0 / math.sqrt(_fan_in(name, p)) / _TRUNC_STD)
        state[name] = t
    return state


def init_net_params(generator: torch.Generator, width: float = 1.0,
                    with_phase_decoder: bool = False) -> Dict[str, torch.Tensor]:
    """A fresh state dict of ``StyleTransferNet(width, with_phase_decoder)``
    (``init_params``); the JAX package's ``init_net_params``."""
    return init_params(StyleTransferNet(width=width, with_phase_decoder=with_phase_decoder),
                       generator)
