"""Fused 3x3 conv stacks of the int8 serving path: Hopper kernels, wrappers,
plain versions.

Two kernels of ``csrc/conv_stack.cu``, built by ``_build`` with ``nvcc`` and
called through ``ctypes``, replace the JAX package's kernels/conv_stack.py:

* ``fused_encoder_head`` (``_head_kernel``): conv1_1 -> relu -> conv1_2 ->
  relu -> 2x2/2 max pool, ``(B, C, H, W)`` -> ``(B, O2, H/2, W/2)``;
* ``fused_conv_tail`` (``_tail_kernel``): conv8 -> relu -> conv9 -> relu ->
  conv10, ``(B, C, H, W)`` -> ``(B, O10, H, W)``.

Each layer is ``_conv3x3``'s arithmetic: a ReflectionPad2d(1) of the
layer's own input, exact products (bf16 x bf16 or fp32 x fp32) summed in
fp32, the fp32 bias added before the cast, the relu, and the result rounded
to the input type. With one input channel the taps are summed one by one in
the TPU kernel's order. Nothing between the layers goes to device memory.

In bf16 the tail runs on the tensor cores (wgmma), and so do the halo
kernels (``halo_conv``), which share its tile body, and the head's conv1_2:
each such layer is an implicit GEMM over 9 taps x 16-channel steps whose
weights the host packs with ``pack_tc_weights``; ``conv_tail_packed`` and
``encoder_head_packed`` are those products written as plain tensor ops.
The head's conv1_1 (one or three input channels) stays on the CUDA cores
with an fp32 ``_tap_major`` copy, as every layer does in fp32, where the
kernels run on the CUDA cores. The input type decides, with one
exception: the tensor-core bodies stage a layer's whole weights in shared
memory, which holds one 64-channel block a layer (every release's width).
A bf16 stack wider than that runs the SIMT body in bf16; ``TC_LAUNCHES``
counts the launches that ran on the tensor cores.

Inputs are NCHW in fp32 or bf16, kernels OIHW in the input type, biases
fp32; H and W even and >= 4, as the JAX package's ``_use_fused`` admits.
Each kernel is a custom op (``holostyle::fused_encoder_head``,
``holostyle::fused_conv_tail``; ``library``) whose CPU implementation is
its plain PyTorch version; beside it a launch count. For a CUDA tensor the
op launches the kernel or raises; it never falls back.

``conv_tail_reference`` is the JAX package's function of that name: the
tail as three separate library convs, each rounding twice (see there). The
halo tail (``halo_conv``) takes its edge rows from it.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from style_transfer_based_holographic_imaging_tpu_torch.kernels import _build, library

__all__ = [
    "fused_encoder_head",
    "fused_conv_tail",
    "encoder_head_plain",
    "conv_tail_plain",
    "conv_tail_reference",
    "conv_tail_packed",
    "encoder_head_packed",
    "pack_tc_weights",
    "TC_N_TILES",
    "HEAD_TC_TILES",
    "LAUNCHES",
    "TC_LAUNCHES",
    "reset_launches",
]

# Launches of each kernel by its wrapper, and those of them that ran the
# tensor-core body.
LAUNCHES = {"fused_encoder_head": 0, "fused_conv_tail": 0}
TC_LAUNCHES = {"fused_encoder_head": 0, "fused_conv_tail": 0}

_SOURCE = "conv_stack"
# The multiple each tail layer's output channels are padded to in its
# packed blocks: conv8's and conv9's products take 64 output channels at a
# time (wgmma's M), conv10's 8 (wgmma's least N).
TC_N_TILES = (64, 64, 8)
# The head in bf16: conv1_1 takes the fp32 tap-major copy (None), conv1_2
# the packed blocks, its output channels padded to 64.
HEAD_TC_TILES = (None, 64)
# The body code of the entry points: fp32 and bf16 on the SIMT body, bf16
# on the tensor cores.
_SIMT = {torch.float32: 0, torch.bfloat16: 2}
_TENSOR_CORES = 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        TC_LAUNCHES[k] = 0


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


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def pack_tc_weights(k: torch.Tensor, n_tile: int) -> torch.Tensor:
    """OIHW kernel -> the blocks the tensor-core tail reads, ``(9, N, C16)``
    in k's dtype: tap ``3*kh + kw`` major, then the output channel (N = O
    padded with zeros to a multiple of ``n_tile``), then the input channel
    (C16 = C padded with zeros to a multiple of 16), so each tap's block is
    K-major, as wgmma takes its operands (conv8's and conv9's weights are
    the products' A, conv10's their B)."""
    o, c = k.shape[:2]
    packed = k.new_zeros(9, _round_up(o, n_tile), _round_up(c, 16))
    packed[:, :o, :c] = k.permute(2, 3, 0, 1).reshape(9, o, c)
    return packed


def conv_tail_packed(x, k8, b8, k9, b9, k10, b10):
    """conv8 -> relu -> conv9 -> relu -> conv10 as the tensor-core tail
    sums it, in plain tensor ops: per layer an im2col product over the
    ``pack_tc_weights`` blocks, the activations channels-last and padded
    with zero channels to a multiple of 16, summed in fp32 tap by tap and
    16 channels at a time (the kernel's K order; each 16-long dot product's
    own order is the library's), the fp32 bias, the relu, one rounding to
    x's dtype."""
    dt = x.dtype
    b, c, h, w = x.shape
    a = F.pad(x, (0, 0, 0, 0, 0, _round_up(c, 16) - c))
    for (k, bias, relu), n_tile in zip(((k8, b8, True), (k9, b9, True), (k10, b10, False)),
                                       TC_N_TILES):
        packed = pack_tc_weights(k, n_tile).float()
        xp = F.pad(a.float(), (1, 1, 1, 1), mode="reflect").permute(0, 2, 3, 1)
        acc = torch.zeros(b, h, w, packed.shape[1], device=x.device)
        for t in range(9):
            kh, kw = divmod(t, 3)
            win = xp[:, kh : kh + h, kw : kw + w]
            for c0 in range(0, packed.shape[2], 16):
                acc += win[..., c0 : c0 + 16] @ packed[t, :, c0 : c0 + 16].T
        o = k.shape[0]
        y = acc[..., :o] + bias.float()
        if relu:
            y = torch.relu(y)
        y = y.to(dt).permute(0, 3, 1, 2)
        a = F.pad(y, (0, 0, 0, 0, 0, _round_up(o, 16) - o))
    return a[:, : k10.shape[0]].contiguous()


def encoder_head_packed(x, k1, b1, k2, b2):
    """conv1_1 -> relu -> conv1_2 -> relu -> 2x2 pool as the tensor-core
    head sums it, in plain tensor ops: conv1_1 per input channel over the 9
    taps in (kh, kw) order, each product added to the fp32 sum in turn (with
    one channel the JAX kernel's broadcast branch), then the fp32 bias, the
    relu and one rounding; conv1_2 an im2col product over the
    ``pack_tc_weights`` blocks, channels-last with the channels padded with
    zeros to a multiple of 16, summed in fp32 tap by tap and 16 channels at
    a time (the kernel's K order; each 16-long dot product's own order is
    the library's), the fp32 bias, the relu, one rounding; then the max of
    each 2x2 quad of the rounded values."""
    dt = x.dtype
    b, c, h, w = x.shape
    xp = F.pad(x.float(), (1, 1, 1, 1), mode="reflect")
    k1f = k1.float()
    acc = torch.zeros(b, k1.shape[0], h, w, device=x.device)
    for ci in range(c):
        for t in range(9):
            kh, kw = divmod(t, 3)
            acc = acc + xp[:, ci : ci + 1, kh : kh + h, kw : kw + w] * k1f[:, ci, kh, kw].view(1, -1, 1, 1)
    a = torch.relu(acc + b1.float().view(1, -1, 1, 1)).to(dt)
    o1 = k1.shape[0]
    a = F.pad(a, (0, 0, 0, 0, 0, _round_up(o1, 16) - o1))
    packed = pack_tc_weights(k2, HEAD_TC_TILES[1]).float()
    ap = F.pad(a.float(), (1, 1, 1, 1), mode="reflect").permute(0, 2, 3, 1)
    acc = torch.zeros(b, h, w, packed.shape[1], device=x.device)
    for t in range(9):
        kh, kw = divmod(t, 3)
        win = ap[:, kh : kh + h, kw : kw + w]
        for c0 in range(0, packed.shape[2], 16):
            acc += win[..., c0 : c0 + 16] @ packed[t, :, c0 : c0 + 16].T
    y = torch.relu(acc[..., : k2.shape[0]] + b2.float()).to(dt).permute(0, 3, 1, 2)
    return F.max_pool2d(y, 2, 2)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.conv_head.argtypes = [i, p, i, i, i, i] + [p, p, i] * 2 + [p, p]
    lib.conv_head.restype = ctypes.c_int
    lib.conv_tail.argtypes = [i, p, i, i, i, i] + [p, p, i] * 3 + [p, p]
    lib.conv_tail.restype = ctypes.c_int
    lib.conv_head_tc.argtypes = [i] * 3
    lib.conv_head_tc.restype = ctypes.c_int
    lib.conv_tail_tc.argtypes = [i] * 4
    lib.conv_tail_tc.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _on_tensor_cores(query: str, device: int, *channels: int) -> bool:
    """Whether the bf16 stack ``query`` (``conv_head_tc`` or
    ``conv_tail_tc``) runs on the tensor cores at these channel counts on
    card ``device``."""
    with torch.cuda.device(device):
        return bool(getattr(_lib(), query)(*channels))


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
    if x.dtype not in _SIMT:
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
           *extra: int, tc_tiles=None) -> torch.Tensor:
    """Launch a conv-stack entry point ``fn(body, x, B, C, H, W, *extra,
    (kernel, bias, O) per layer, out, stream)`` on x's card and count it in
    ``counts[name]``; raise if the launch failed. For a bf16 ``x``,
    ``tc_tiles`` picks the tensor-core body and names per layer the
    ``n_tile`` of its ``pack_tc_weights`` blocks (``TC_N_TILES`` for the
    tail's entry points, ``HEAD_TC_TILES`` for the head's), or None where
    the layer takes the ``_tap_major`` fp32 copy, as every layer does on
    the SIMT body (without ``tc_tiles`` or in fp32)."""
    x = x.contiguous()
    if tc_tiles is None or x.dtype != torch.bfloat16:
        body, tc_tiles = _SIMT[x.dtype], (None,) * len(layers)
    else:
        body = _TENSOR_CORES
    weights = [(_tap_major(k) if n is None else pack_tc_weights(k, n), bias.contiguous())
               for (k, bias), n in zip(layers, tc_tiles)]
    ptrs = [v for (kt, bt), (k, _) in zip(weights, layers)
            for v in (kt.data_ptr(), bt.data_ptr(), k.shape[0])]
    b, c, h, w = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        status = fn(body, x.data_ptr(), b, c, h, w, *extra, *ptrs, out.data_ptr(), stream)
    _build.check_status(status, name)
    counts[name] += 1
    return out


def _head_cpu(x: torch.Tensor, k1: torch.Tensor, b1: torch.Tensor, k2: torch.Tensor,
              b2: torch.Tensor) -> torch.Tensor:
    return encoder_head_plain(x, k1, b1, k2, b2)


def _head_cuda(x, k1, b1, k2, b2):
    b, c, h, w = x.shape
    tc = x.dtype == torch.bfloat16 and _on_tensor_cores(
        "conv_head_tc", x.device.index, c, k1.shape[0], k2.shape[0])
    out = torch.empty(b, k2.shape[0], h // 2, w // 2, dtype=x.dtype, device=x.device)
    launch(LAUNCHES, "fused_encoder_head", _lib().conv_head, x, ((k1, b1), (k2, b2)), out,
           tc_tiles=HEAD_TC_TILES if tc else None)
    TC_LAUNCHES["fused_encoder_head"] += tc
    return out


def _head_fake(x, k1, b1, k2, b2):
    b, _, h, w = x.shape
    return x.new_empty(b, k2.shape[0], h // 2, w // 2)


def _tail_cpu(x: torch.Tensor, k8: torch.Tensor, b8: torch.Tensor, k9: torch.Tensor,
              b9: torch.Tensor, k10: torch.Tensor, b10: torch.Tensor) -> torch.Tensor:
    return conv_tail_plain(x, k8, b8, k9, b9, k10, b10)


def _tail_cuda(x, k8, b8, k9, b9, k10, b10):
    b, c, h, w = x.shape
    tc = x.dtype == torch.bfloat16 and _on_tensor_cores(
        "conv_tail_tc", x.device.index, c, k8.shape[0], k9.shape[0], k10.shape[0])
    out = torch.empty(b, k10.shape[0], h, w, dtype=x.dtype, device=x.device)
    launch(LAUNCHES, "fused_conv_tail", _lib().conv_tail, x, ((k8, b8), (k9, b9), (k10, b10)),
           out, tc_tiles=TC_N_TILES if tc else None)
    TC_LAUNCHES["fused_conv_tail"] += tc
    return out


def _tail_fake(x, k8, b8, k9, b9, k10, b10):
    b, _, h, w = x.shape
    return x.new_empty(b, k10.shape[0], h, w)


_HEAD = library.kernel_op("fused_encoder_head", _head_cpu, _head_cuda, _head_fake)
_TAIL = library.kernel_op("fused_conv_tail", _tail_cpu, _tail_cuda, _tail_fake)


def fused_encoder_head(x, k1, b1, k2, b2):
    """conv1_1/relu/conv1_2/relu/2x2 pool of ``x`` ``(B, C, H, W)`` in one
    kernel: ``(B, O2, H/2, W/2)`` in ``x``'s dtype. The op
    ``holostyle::fused_encoder_head``."""
    _check(x, ((k1, b1), (k2, b2)))
    return _HEAD(x, k1, b1, k2, b2)


def fused_conv_tail(x, k8, b8, k9, b9, k10, b10):
    """conv8/relu/conv9/relu/conv10 of ``x`` ``(B, C, H, W)`` in one kernel:
    ``(B, O10, H, W)`` in ``x``'s dtype. The op
    ``holostyle::fused_conv_tail``."""
    _check(x, ((k8, b8), (k9, b9), (k10, b10)))
    return _TAIL(x, k8, b8, k9, b9, k10, b10)
