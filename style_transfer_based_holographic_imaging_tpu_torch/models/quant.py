"""The int8 serving path (port of the JAX package's ``models/quant.py``).

Plain functions over the port's ``StyleTransferNet`` weights, the
counterpart of JAX's pure functions over the same params pytree: the
encoder and decoder ladders run again here with

* weights quantized to symmetric int8 per output channel, at call time,
  from the net's fp32 weights;
* activations quantized to symmetric int8 per tensor with static scales
  calibrated offline (``calibrate_scales``), the reflect pad applied to the
  quantized activations;
* each conv as im2col and an int8 x int8 -> int32 product (``torch._int_mm``,
  exact as XLA's int32 conv is), then one multiply-add in the compute dtype
  (dequant and bias) and the relu;
* everything else (the stem folded into conv1_1, the transposed convs,
  AdaIN, the distance head) in the compute dtype, bf16 by default.

A conv runs int8 iff its name is in the scales; with ``scales=None`` the
path is the fp network's math in the compute dtype. With the fused stacks
on (``set_fused_stacks("on")``), conv1_1/conv1_2/pool and conv8/9/10 run as
the two kernels of ``kernels/conv_stack.py`` in the compute dtype, skipping
their int8 scales, as in the JAX package.

Layouts are the port's: NCHW activations, OIHW kernels.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from style_transfer_based_holographic_imaging_tpu_torch.kernels.conv_stack import (
    fused_conv_tail,
    fused_encoder_head,
)
from style_transfer_based_holographic_imaging_tpu_torch.models.layers import (
    conv_in_dtype,
    max_pool_ceil,
)
from style_transfer_based_holographic_imaging_tpu_torch.models.net import style_stats_nchw
from style_transfer_based_holographic_imaging_tpu_torch.models.vgg import _BLOCKS
from style_transfer_based_holographic_imaging_tpu_torch.ops.stats import (
    adain_with_stats,
    calc_mean_std,
)

__all__ = [
    "quant_retrieval_forward",
    "quant_encode",
    "quant_decode",
    "int8_conv_valid",
    "calibrate_scales",
    "save_scales",
    "load_scales",
    "set_fused_stacks",
]

# The fused head/tail stacks: "on", "off" or "auto" ("off", as in the JAX
# package, where they measured no faster than the XLA composition).
_FUSED_STACKS = "off"

# Decoder ladder: (kind, name) in order, as AmpPhaseDecoder runs it.
_DEC_LADDER: Tuple[Tuple[str, str], ...] = (
    ("conv", "conv0"),
    ("conv", "conv1"),
    ("up", "up0"),
    ("conv", "conv2"),
    ("conv", "conv3"),
    ("conv", "conv4"),
    ("conv", "conv5"),
    ("up", "up1"),
    ("conv", "conv6"),
    ("conv", "conv7"),
    ("up", "up2"),
    ("conv", "conv8"),
    ("conv", "conv9"),
    ("conv", "conv10"),  # no relu
)


def set_fused_stacks(mode: str) -> None:
    """The fused conv stacks: 'on', 'off' or 'auto' (= 'off')."""
    global _FUSED_STACKS
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"unknown fused-stack mode {mode!r}")
    _FUSED_STACKS = mode


def _use_fused(x: torch.Tensor, observer, channels: int = 64) -> bool:
    """Whether the fused stacks apply to ``x`` ``(B, C, H, W)``: stacks on, no
    calibration pass, H and W even and >= 4, and the footprint estimate
    ``H W max(C, channels) 12`` bytes within 64 MB. That figure is the TPU's
    VMEM rule, kept so that both packages take the same path for a shape."""
    if _FUSED_STACKS != "on" or observer is not None:
        return False
    c, h, w = x.shape[1], x.shape[2], x.shape[3]
    if h < 4 or h % 2 or w < 4 or w % 2:
        return False
    return h * w * max(c, channels) * 12 <= 64 * 1024 * 1024


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x * scale), -127, 127)`` as int8; ``torch.round`` rounds
    half to even, as ``jnp.round`` does."""
    return torch.clamp(torch.round(x * scale), -127.0, 127.0).to(torch.int8)


def _int8_conv(xq: torch.Tensor, kq: torch.Tensor) -> torch.Tensor:
    """VALID conv of int8 ``xq`` ``(B, C, H + kh - 1, W + kw - 1)`` by int8
    ``kq`` ``(O, C, kh, kw)`` with int32 sums: ``(B, O, H, W)`` int32, exact.

    im2col, then ``torch._int_mm``; K = kh kw C and N = O are padded with
    zeros to the multiples of 8 that ``_int_mm`` needs on CUDA (zeros keep it
    exact).
    """
    b, c, hp, wp = xq.shape
    o, _, kh, kw = kq.shape
    h, w = hp - kh + 1, wp - kw + 1
    x_hwc = xq.permute(0, 2, 3, 1)
    cols = torch.cat(
        [x_hwc[:, di : di + h, dj : dj + w, :] for di in range(kh) for dj in range(kw)], dim=-1
    ).reshape(b * h * w, kh * kw * c)
    kmat = kq.permute(2, 3, 1, 0).reshape(kh * kw * c, o)  # rows (di, dj, c), as the columns
    pad_k, pad_n = -(kh * kw * c) % 8, -o % 8
    if pad_k:
        cols = F.pad(cols, (0, pad_k))
        kmat = F.pad(kmat, (0, 0, 0, pad_k))
    if pad_n:
        kmat = F.pad(kmat, (0, pad_n))
    acc = torch._int_mm(cols, kmat.contiguous())[:, :o]
    return acc.reshape(b, h, w, o).permute(0, 3, 1, 2)


def int8_conv_valid(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor,
    *,
    dt: torch.dtype,
    act_max: torch.Tensor,
    relu: bool,
    reflect_pad: bool = True,
) -> torch.Tensor:
    """The int8 serving epilogue: a per-tensor activation scale from the
    calibrated absmax, per-output-channel kernel scales, int8 quantize (the
    reflect pad applied to the quantized activations; ``reflect_pad=False``
    for an input padded already, as the packed convs of
    ``kernels/packed_conv.py`` give it), the int32 VALID conv, then
    ``acc * 1/(sx sk) + bias`` in ``dt`` and the relu."""
    # Tensor / tensor divisions: ``127.0 / t`` would be ``reciprocal(t) * 127``
    # in torch, two roundings where XLA's division has one.
    c127 = torch.tensor(127.0, device=x.device)
    sx = c127 / torch.clamp(act_max.float().to(x.device), min=1e-8)
    k32 = kernel.float()
    sk = c127 / torch.clamp(k32.abs().amax(dim=(1, 2, 3)), min=1e-8)  # (O,)
    xq = _quantize(x.float(), sx)
    if reflect_pad:
        xq = F.pad(xq, (1, 1, 1, 1), mode="reflect")
    kq = _quantize(k32, sk.view(-1, 1, 1, 1))
    acc = _int8_conv(xq, kq)
    m = (1.0 / (sx * sk)).to(dt).view(1, -1, 1, 1)
    y = acc.to(dt) * m + bias.to(dt).view(1, -1, 1, 1)
    return torch.relu(y) if relu else y


def _reflect_conv(x, kernel, bias, *, dt, act_max, relu):
    """One ReflectionPad2d(1) + 3x3 VALID conv: int8 when ``act_max`` is given,
    else the fp math of ``ReflectConv`` (matpad) in ``dt``."""
    if act_max is None:
        y = conv_in_dtype(F.conv2d, F.pad(x.to(dt), (1, 1, 1, 1), mode="reflect"), kernel, bias, dt)
        return torch.relu(y) if relu else y
    return int8_conv_valid(x, kernel, bias, dt=dt, act_max=act_max, relu=relu)


class _Observer:
    """Records each conv's input absmax during calibration passes."""

    def __init__(self) -> None:
        self.maxes: Dict[str, torch.Tensor] = {}

    def see(self, name: str, x: torch.Tensor) -> None:
        self.maxes[name] = x.float().abs().max()


def _layer_scale(scales, observer, name: str, x: torch.Tensor, max_hw: int):
    """This conv's activation absmax if it runs int8, else None."""
    if observer is not None and x.shape[2] <= max_hw:
        observer.see(name, x)
    if scales is None or x.shape[2] > max_hw or name not in scales:
        return None
    return torch.tensor(float(scales[name]), dtype=torch.float32)


def _fold_stem(encoder) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 1x1 grayscale stem composed into conv1_1, in fp32 (exact up to
    rounding: the stem is pointwise affine and commutes with the reflect
    pad). Returns the folded ``(F, 1, 3, 3)`` kernel and ``(F,)`` bias."""
    stem_k = encoder.stem.weight.float()[:, 0, 0, 0]  # (3,)
    stem_b = encoder.stem.bias.float()                # (3,)
    k11 = encoder.conv1_1.weight.float()              # (F, 3, 3, 3)
    b11 = encoder.conv1_1.bias.float()
    k_f = torch.einsum("o,fohw->fhw", stem_k, k11)[:, None]
    b_f = b11 + torch.einsum("fohw,o->f", k11, stem_b)
    return k_f, b_f


def quant_encode(
    encoder,
    x: torch.Tensor,
    *,
    scales: Optional[Dict[str, float]] = None,
    observer: Optional[_Observer] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    max_hw: int = 128,
    n_taps: int = 4,
    fold_stem: bool = True,
) -> torch.Tensor:
    """VGG encode of ``x`` ``(B, 1, H, W)`` to relu4_1 with int8 convs."""
    dt = compute_dtype
    x = x.to(dt)
    folded = _fold_stem(encoder) if fold_stem else None
    if not fold_stem:
        stem = encoder.stem
        x = conv_in_dtype(F.conv2d, x, stem.weight, stem.bias, dt)
    fused_head = _use_fused(x, observer, channels=encoder.conv1_1.out_channels) and n_taps >= 2
    if fused_head:
        k1, b1 = folded if folded is not None else (encoder.conv1_1.weight, encoder.conv1_1.bias)
        c2 = encoder.conv1_2
        # conv1_1 -> relu -> conv1_2 -> relu -> pool in one kernel; the pool
        # is conv2_1's pool_before.
        x = fused_encoder_head(x, k1.to(dt), b1.float(), c2.weight.to(dt), c2.bias.float())

    for block in _BLOCKS[:n_taps]:
        for name, _, pool_before in block:
            if fused_head and name in ("conv1_1", "conv1_2"):
                continue
            if pool_before and not (fused_head and name == "conv2_1"):
                x = max_pool_ceil(x, 2, 2)
            if folded is not None and name == "conv1_1":
                kernel, bias = folded
            else:
                conv = getattr(encoder, name)
                kernel, bias = conv.weight, conv.bias
            am = _layer_scale(scales, observer, f"encoder.{name}", x, max_hw)
            x = _reflect_conv(x, kernel, bias, dt=dt, act_max=am, relu=True)
    return x


def quant_decode(
    decoder,
    t: torch.Tensor,
    *,
    scales: Optional[Dict[str, float]] = None,
    observer: Optional[_Observer] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    max_hw: int = 128,
    prefix: str = "decoder",
) -> torch.Tensor:
    """relu4_1 features -> ``(B, 2, H, W)`` amplitude and phase. ``prefix``
    names the scales' namespace: "decoder", or "decoder_ph" for the
    dedicated phase head."""
    dt = compute_dtype
    x = t.to(dt)
    for i, (kind, name) in enumerate(_DEC_LADDER):
        layer = getattr(decoder, name)
        if kind == "up":
            # ConvTranspose2d(k=2, s=2)
            x = torch.relu(conv_in_dtype(F.conv_transpose2d, x, layer.weight, layer.bias, dt, stride=2))
            continue
        if name == "conv8" and _use_fused(x, observer, channels=x.shape[1]):
            c9, c10 = decoder.conv9, decoder.conv10
            return fused_conv_tail(
                x.contiguous(),
                layer.weight.to(dt), layer.bias.float(),
                c9.weight.to(dt), c9.bias.float(),
                c10.weight.to(dt), c10.bias.float(),
            )
        last = i == len(_DEC_LADDER) - 1
        am = _layer_scale(scales, observer, f"{prefix}.{name}", x, max_hw)
        x = _reflect_conv(x, layer.weight, layer.bias, dt=dt, act_max=am, relu=not last)
    return x


def quant_retrieval_forward(
    net,
    content: torch.Tensor,
    style_mean: torch.Tensor,
    style_std: torch.Tensor,
    alpha: float = 1.0,
    *,
    scales: Optional[Dict[str, float]] = None,
    observer: Optional[_Observer] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    max_hw: int = 128,
    unknown_distance: bool = True,
):
    """int8 ``StyleTransferNet.field_retrieval``: the sqrt-intensity hologram
    ``(B, 1, H, W)`` -> (amp, phase[, d]) in ``compute_dtype``, like the net's
    method. ``style_mean``/``style_std`` broadcast against NCHW features."""
    kw = dict(scales=scales, observer=observer, compute_dtype=compute_dtype, max_hw=max_hw)
    content_feat = quant_encode(net.encoder, content, **kw)
    t = adain_with_stats(content_feat, style_mean, style_std)
    t = alpha * t + (1.0 - alpha) * content_feat
    g = quant_decode(net.decoder, t, **kw)
    amp, phase = g[:, 0:1], g[:, 1:2]
    if getattr(net, "with_phase_decoder", False):
        phase = quant_decode(net.decoder_ph, t, prefix="decoder_ph", **kw)[:, 0:1]
    if not unknown_distance:
        return amp, phase
    d = net.distance_g(calc_mean_std(content_feat), dtype=compute_dtype)
    return amp, phase, d


@torch.inference_mode()
def calibrate_scales(
    net,
    content_batches: Iterable,
    style_mean,
    style_std,
    *,
    alpha: float = 1.0,
    compute_dtype: torch.dtype = torch.bfloat16,
    max_hw: int = 128,
    margin: float = 1.0,
    device: str | torch.device = "cuda",
) -> Dict[str, float]:
    """Per-conv input absmax over fp calibration passes, times ``margin``.

    ``content_batches``: sqrt-intensity hologram batches ``(B, 1, H, W)``.
    The returned ``{conv_name: absmax}`` feeds ``quant_retrieval_forward``.
    """
    device = torch.device(device)
    f32 = dict(dtype=torch.float32, device=device)
    sm = style_stats_nchw(torch.as_tensor(np.asarray(style_mean), **f32))
    ss = style_stats_nchw(torch.as_tensor(np.asarray(style_std), **f32))
    agg: Dict[str, float] = {}
    for batch in content_batches:
        obs = _Observer()
        quant_retrieval_forward(
            net, torch.as_tensor(np.asarray(batch), **f32), sm, ss, alpha,
            observer=obs, compute_dtype=compute_dtype, max_hw=max_hw, unknown_distance=False,
        )
        for k, v in obs.maxes.items():
            agg[k] = max(agg.get(k, 0.0), float(v))
    return {k: v * margin for k, v in agg.items()}


def save_scales(scales: Dict[str, float], path: str) -> None:
    with open(path, "w") as f:
        json.dump({k: float(v) for k, v in scales.items()}, f, indent=1, sort_keys=True)


def load_scales(path: str) -> Dict[str, float]:
    with open(path) as f:
        return json.load(f)
