"""Fused 3x3 conv stacks of the int8 serving path: Hopper kernels, wrappers,
plain versions.

Two kernels of ``csrc/conv_stack.cu``, built by ``_build`` with ``nvcc`` and
called through ``ctypes``, replace the JAX package's kernels/conv_stack.py:

* ``fused_encoder_head`` (``_head_kernel``): conv1_1 -> relu -> conv1_2 ->
  relu -> 2x2/2 max pool, ``(B, C, H, W)`` -> ``(B, O2, H/2, W/2)``;
* ``fused_conv_tail`` (``_tail_kernel``): conv8 -> relu -> conv9 -> relu ->
  conv10, ``(B, C, H, W)`` -> ``(B, O10, H, W)``.

Each layer is ``_conv3x3``'s arithmetic: a ReflectionPad2d(1) of the
layer's own input, fp32 products (exact for bf16 operands) summed in fp32,
the fp32 bias added before the cast, the relu, and the result rounded to the
input type. With one input channel the taps are summed one by one in the
TPU kernel's order. Nothing between the layers goes to device memory.

Inputs are NCHW in fp32 or bf16, kernels OIHW in the input type, biases
fp32; H and W even and >= 4, as the JAX package's ``_use_fused`` admits.
Beside each kernel: its plain PyTorch version, which the wrapper takes only
for a tensor on the CPU, and a launch count. For a CUDA tensor the wrapper
launches the kernel or raises; it never falls back.

``conv_tail_reference`` is the JAX package's function of that name: the
tail as three separate library convs, each rounding twice (see there). The
halo tail (``halo_conv``) takes its edge rows from it.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from style_transfer_based_holographic_imaging_tpu_torch.kernels import _build

__all__ = [
    "fused_encoder_head",
    "fused_conv_tail",
    "encoder_head_plain",
    "conv_tail_plain",
    "conv_tail_reference",
    "LAUNCHES",
    "reset_launches",
]

# Launches of each kernel by its wrapper.
LAUNCHES = {"fused_encoder_head": 0, "fused_conv_tail": 0}

_SOURCE = "conv_stack"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _conv3x3_plain(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor, relu: bool) -> torch.Tensor:
    """One layer of the stack as plain tensor ops, in ``_conv3x3``'s dtypes."""
    h, w = x.shape[-2], x.shape[-1]
    xp = F.pad(x.float(), (1, 1, 1, 1), mode="reflect")
    kf = k.float()
    if x.shape[1] == 1:
        # The broadcast branch: the nine taps summed one by one in fp32.
        acc = None
        for di in range(3):
            for dj in range(3):
                a = xp[:, :, di : di + h, dj : dj + w] * kf[:, 0, di, dj].view(1, -1, 1, 1)
                acc = a if acc is None else acc + a
    else:
        acc = F.conv2d(xp, kf)
    y = acc + b.float().view(1, -1, 1, 1)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def encoder_head_plain(x, k1, b1, k2, b2):
    """conv1_1 -> relu -> conv1_2 -> relu -> 2x2 max pool (plain version)."""
    x = _conv3x3_plain(x, k1, b1, relu=True)
    x = _conv3x3_plain(x, k2, b2, relu=True)
    return F.max_pool2d(x, 2, 2)


def conv_tail_plain(x, k8, b8, k9, b9, k10, b10):
    """conv8 -> relu -> conv9 -> relu -> conv10 (plain version)."""
    x = _conv3x3_plain(x, k8, b8, relu=True)
    x = _conv3x3_plain(x, k9, b9, relu=True)
    return _conv3x3_plain(x, k10, b10, relu=False)


def conv_tail_reference(x, k8, b8, k9, b9, k10, b10):
    """conv8 -> relu -> conv9 -> relu -> conv10 as three library convs, in the
    dtype placement of the JAX package's ``conv_tail_reference`` (the XLA
    chain): per layer a ReflectionPad2d(1), the conv with fp32 sums rounded
    to x's dtype, then ``+ bias`` cast to x's dtype and added in that dtype
    (in bf16 a second rounding), then the relu. On the CPU the conv runs on
    fp32 copies and rounds once; on the card it is cuDNN's conv in x's dtype
    (fp32 sums, TF32 off)."""
    dt = x.dtype
    for k, bias, relu in ((k8, b8, True), (k9, b9, True), (k10, b10, False)):
        xp = F.pad(x, (1, 1, 1, 1), mode="reflect")
        if x.device.type == "cpu":
            y = F.conv2d(xp.float(), k.float()).to(dt)
        else:
            y = F.conv2d(xp, k.to(dt))
        x = y + bias.to(dt).view(1, -1, 1, 1)
        if relu:
            x = torch.relu(x)
    return x


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.conv_head.argtypes = [i, p, i, i, i, i] + [p, p, i] * 2 + [p, p]
    lib.conv_head.restype = ctypes.c_int
    lib.conv_tail.argtypes = [i, p, i, i, i, i] + [p, p, i] * 3 + [p, p]
    lib.conv_tail.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, layers) -> None:
    check_stack(x, layers)
    h, w = x.shape[-2:]
    if h < 4 or w < 4 or h % 2 or w % 2:
        raise ValueError(f"the fused stacks need H, W even and >= 4, got {h}x{w}")


def check_stack(x: torch.Tensor, layers) -> None:
    """Raise on what a conv-stack kernel does not take: ``x`` NCHW fp32 or
    bf16 on the CPU or a card (contiguous there); each ``(kernel, bias)``
    OIHW 3x3 in x's dtype chaining the channels, with an fp32 bias, on x's
    device."""
    if x.ndim != 4:
        raise ValueError(f"x must be (B, C, H, W), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the conv stacks take CPU or CUDA tensors, got {x.device}")
    c = x.shape[1]
    for k, bias in layers:
        if k.ndim != 4 or tuple(k.shape[1:]) != (c, 3, 3):
            raise ValueError(f"kernel {tuple(k.shape)} does not take {c} input channels as 3x3")
        if k.dtype != x.dtype:
            raise TypeError(f"kernels must be in the input's dtype {x.dtype}, got {k.dtype}")
        if bias.dtype != torch.float32 or tuple(bias.shape) != (k.shape[0],):
            raise ValueError(f"bias must be float32 ({k.shape[0]},), got {bias.dtype} {tuple(bias.shape)}")
        if k.device != x.device or bias.device != x.device:
            raise ValueError("kernels and biases must lie on the input's device")
        c = k.shape[0]
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError("x must be contiguous")


def _tap_major(k: torch.Tensor) -> torch.Tensor:
    """OIHW kernel -> the kernel's fp32 (C_in, 3, 3, C_out) copy (exact)."""
    return k.float().permute(1, 2, 3, 0).contiguous()


def launch(counts: dict, name: str, fn, x: torch.Tensor, layers, out: torch.Tensor,
           *extra: int) -> torch.Tensor:
    """Launch a conv-stack entry point ``fn(dtype, x, B, C, H, W, *extra,
    (kernel, bias, O) per layer, out, stream)`` on x's card and count it in
    ``counts[name]``; raise if the launch failed."""
    weights = [(_tap_major(k), bias.contiguous()) for k, bias in layers]
    ptrs = [v for kt, bt in weights for v in (kt.data_ptr(), bt.data_ptr(), kt.shape[-1])]
    b, c, h, w = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        status = fn(_DTYPES[x.dtype], x.data_ptr(), b, c, h, w, *extra, *ptrs, out.data_ptr(), stream)
    _build.check_status(status, name)
    counts[name] += 1
    return out


def fused_encoder_head(x, k1, b1, k2, b2):
    """conv1_1/relu/conv1_2/relu/2x2 pool of ``x`` ``(B, C, H, W)`` in one
    kernel: ``(B, O2, H/2, W/2)`` in ``x``'s dtype."""
    layers = ((k1, b1), (k2, b2))
    _check(x, layers)
    if x.device.type == "cpu":
        return encoder_head_plain(x, k1, b1, k2, b2)
    b, _, h, w = x.shape
    out = torch.empty(b, k2.shape[0], h // 2, w // 2, dtype=x.dtype, device=x.device)
    return launch(LAUNCHES, "fused_encoder_head", _lib().conv_head, x, layers, out)


def fused_conv_tail(x, k8, b8, k9, b9, k10, b10):
    """conv8/relu/conv9/relu/conv10 of ``x`` ``(B, C, H, W)`` in one kernel:
    ``(B, O10, H, W)`` in ``x``'s dtype."""
    layers = ((k8, b8), (k9, b9), (k10, b10))
    _check(x, layers)
    if x.device.type == "cpu":
        return conv_tail_plain(x, k8, b8, k9, b9, k10, b10)
    b, _, h, w = x.shape
    out = torch.empty(b, k10.shape[0], h, w, dtype=x.dtype, device=x.device)
    return launch(LAUNCHES, "fused_conv_tail", _lib().conv_tail, x, layers, out)
