"""The reflect-conv border ring: Hopper kernel, wrapper, plain version.

``border_lines`` launches ``border_lines`` of ``csrc/reflect_border.cu``
(built by ``_build`` with ``nvcc``, called through ``ctypes``), which
replaces ``_make_kernel`` of the JAX package's kernels/reflect_border.py.
``ReflectConv``'s ``cuda`` and ``einsum`` backends run a SAME convolution and
overwrite its one-pixel border ring with these lines; the ring comes from
the four edge lines of each side alone, the taps folded to ``k0 + k2``
against the reflected neighbour line and ``k1`` against the edge line, in
fp32 before the multiply, with fp32 sums.

On the card the ring is one fp32 GEMM per line orientation over every ring
position of the batch (the design in the source's header): a prologue
folds the taps once per call into the K-major array that ``ring_taps``
writes as plain tensor ops, bit for bit the JAX kernel's fold.

Layouts are the port's: ``x`` ``(B, C, H, W)``, ``k`` ``(O, C, 3, 3)``,
both fp32 or both bf16. Returns ``rows`` ``(B, O, 2, W)`` (output rows 0
and H-1) and ``cols`` ``(B, O, H, 2)`` (output columns 0 and W-1 over all
rows; the corners equal the rows' values), in the input type.

``border_lines`` calls the custom op ``holostyle::border_lines``
(``library``), whose CPU implementation is ``border_lines_plain``, the
counterpart of the JAX package's ``border_lines_einsum``. On a CUDA tensor
it launches the kernel or raises, for any H (the JAX kernel's even-H
restriction is a TPU block-layout limit).

The gradient: the op's registered backward is the VJP of
``border_lines_plain``, the counterpart of the JAX package's
``_border_lines_cvjp`` (the Pallas forward paired with the einsum's VJP).
Under ``torch.no_grad`` the op saves nothing.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from style_transfer_based_holographic_imaging_tpu_torch.kernels import _build, library

__all__ = ["border_lines", "border_lines_plain", "ring_taps", "LAUNCHES", "reset_launches"]

# Launches of the kernel by its wrapper.
LAUNCHES = {"border_lines": 0}

_SOURCE = "reflect_border"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The kernel's blocks take 64 output channels: the folded taps' rows are
# padded to a multiple of it.
_BM = 64


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _contract(line: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """``line`` ``(B, C, 2, L)`` reflect-padded along L by one and windowed
    against ``taps`` ``(O, C, 3)``: ``(B, O, 2, L)`` fp32."""
    n = line.shape[-1]
    idx = torch.cat([torch.tensor([1]), torch.arange(n), torch.tensor([n - 2])]).to(line.device)
    padded = line.float().index_select(-1, idx)
    win = torch.stack([padded[..., j : j + n] for j in range(3)], dim=3)  # (B, C, 2, 3, L)
    return torch.einsum("bcsjl,ocj->bosl", win, taps)


def border_lines_plain(x: torch.Tensor, k: torch.Tensor):
    """The border ring as plain tensor ops (the kernel's plain version)."""
    h, w = x.shape[-2], x.shape[-1]
    kf = k.float()
    near_r = torch.stack([x[:, :, 1], x[:, :, h - 2]], dim=2)          # (B, C, 2, W)
    edge_r = torch.stack([x[:, :, 0], x[:, :, h - 1]], dim=2)
    rows = _contract(near_r, kf[:, :, 0] + kf[:, :, 2]) + _contract(edge_r, kf[:, :, 1])
    near_c = torch.stack([x[..., 1], x[..., w - 2]], dim=2)            # (B, C, 2, H)
    edge_c = torch.stack([x[..., 0], x[..., w - 1]], dim=2)
    cols = _contract(near_c, kf[..., 0] + kf[..., 2]) + _contract(edge_c, kf[..., 1])
    return rows.to(x.dtype), cols.transpose(2, 3).to(x.dtype)


def ring_taps(k: torch.Tensor) -> torch.Tensor:
    """The folded taps the kernel multiplies by, ``(2, 6, C, O64)`` fp32:
    orientation (rows, columns), then (near line, edge line) x the 3 taps
    along the line, then the input channel, then the output channel padded
    with zeros to a multiple of 64. Rows fold the kernel's rows, ``k[:, :,
    0] + k[:, :, 2]`` against the near line and ``k[:, :, 1]`` against the
    edge line, columns its columns, each sum in fp32: the JAX kernel's
    ``k_sym``, ``k_mid``, ``kt_sym`` and ``kt_mid``."""
    o, c = k.shape[:2]
    kf = k.float()
    parts = (kf[:, :, 0] + kf[:, :, 2], kf[:, :, 1],        # rows: (O, C, 3) along W
             kf[..., 0] + kf[..., 2], kf[..., 1])           # columns: (O, C, 3) along H
    folded = torch.stack(parts).permute(0, 3, 2, 1).reshape(2, 6, c, o)
    taps = folded.new_zeros(2, 6, c, -(-o // _BM) * _BM)
    taps[..., :o] = folded
    return taps


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.border_lines.argtypes = [i, p, p, p, p, p, i, i, i, i, i, p]
    lib.border_lines.restype = ctypes.c_int
    return lib


def _border_lines_cpu(x: torch.Tensor, k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    rows, cols = border_lines_plain(x, k)
    return rows.contiguous(), cols.contiguous()


def _border_lines_cuda(x, k):
    x, k = x.contiguous(), k.contiguous()
    b, c, h, w = x.shape
    o = k.shape[0]
    rows = torch.empty(b, o, 2, w, dtype=x.dtype, device=x.device)
    cols = torch.empty(b, o, h, 2, dtype=x.dtype, device=x.device)
    taps = torch.empty(2, 6, c, -(-o // _BM) * _BM, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        status = _lib().border_lines(
            _DTYPES[x.dtype], x.data_ptr(), k.data_ptr(), taps.data_ptr(), rows.data_ptr(),
            cols.data_ptr(), b, c, h, w, o, stream,
        )
    _build.check_status(status, "border_lines")
    LAUNCHES["border_lines"] += 1
    return rows, cols


def _border_lines_fake(x, k):
    b, _, h, w = x.shape
    o = k.shape[0]
    return x.new_empty(b, o, 2, w), x.new_empty(b, o, h, 2)


def _setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, g_rows, g_cols):
    """The VJP of ``border_lines_plain``, recomputed under autograd, as the
    JAX ``custom_vjp`` takes ``jax.vjp`` of the einsum."""
    x, k = ctx.saved_tensors
    with torch.enable_grad():
        xg = x.detach().requires_grad_(ctx.needs_input_grad[0])
        kg = k.detach().requires_grad_(ctx.needs_input_grad[1])
        rows, cols = border_lines_plain(xg, kg)
        wrt = [t for t in (xg, kg) if t.requires_grad]
        grads = iter(torch.autograd.grad((rows, cols), wrt, (g_rows, g_cols)))
    return tuple(next(grads) if t.requires_grad else None for t in (xg, kg))


_BORDER_LINES = library.kernel_op("border_lines", _border_lines_cpu, _border_lines_cuda,
                                  _border_lines_fake, backward=_backward, setup_context=_setup)


def border_lines(x: torch.Tensor, k: torch.Tensor):
    """``(rows, cols)`` of the reflect-padded 3x3 conv of ``x`` by ``k``,
    differentiable in both: the op ``holostyle::border_lines``."""
    if x.ndim != 4 or k.ndim != 4 or tuple(k.shape[1:]) != (x.shape[1], 3, 3):
        raise ValueError(f"want x (B, C, H, W) and k (O, C, 3, 3), got {tuple(x.shape)}, {tuple(k.shape)}")
    if x.dtype not in _DTYPES or k.dtype != x.dtype:
        raise TypeError(f"x and k must both be float32 or bfloat16, got {x.dtype}, {k.dtype}")
    if x.device != k.device or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"x and k must lie on one CPU or CUDA device, got {x.device}, {k.device}")
    h, w = x.shape[-2:]
    if h < 2 or w < 2:
        raise ValueError(f"the ring needs H, W >= 2, got {h}x{w}")
    return _BORDER_LINES(x, k)
