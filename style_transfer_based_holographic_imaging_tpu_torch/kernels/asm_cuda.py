"""The fused angular-spectrum propagator: Hopper kernels, wrappers, plain versions.

Two kernels of ``csrc/asm_propagate.cu``, built by ``_build`` with ``nvcc``,
called through ``ctypes`` and registered as the custom ops
``holostyle::asm_const`` and ``holostyle::asm_dynamic`` (``library``):

* ``asm_const``   replaces ``_make_kernel_const`` (kernels/asm_pallas.py of
  the JAX package), the serving refocus by one host-scalar distance. The
  transfer function ``H = exp(i d kz_rel) exp(i d 2pi/lambda)`` is built once
  per distance on the host, with the fp32 ops of the JAX const path, and
  cached on the device.
* ``asm_dynamic`` replaces ``_make_kernel``, one distance per image: the
  kernel computes ``cos/sin(d kz_rel)`` and applies the global phasor.

Both compute, per image, ``U = C (A x B * H) D``: the replicate pad and the
centre crop are folded into thin DFT factors (``folded_factors``, a copy of
the JAX package's ``_folded_factors``, bit-identical). What bounds them on
the card and what the design does about it is noted in the CUDA source.

In ``high`` and ``bf16`` the kernels run each stage as one real product on
the tensor cores, the complex factor as a real block with re and im stacked
along K (``block_factors``). The host builds those blocks and their bf16
hi/lo planes (``split_hi_lo``) once per (h, w) and passes them in place of
the fp32 factor planes that ``highest`` takes.

Beside each kernel: its plain PyTorch version (the same four complex products
with the same bf16 roundings), the op's implementation for a tensor on the
CPU, and a launch count. For a CUDA tensor the op launches the kernel or
raises; it never falls back.

The gradient: each op's registered backward, the counterpart of the JAX
package's ``_propagate_const_cvjp`` and ``_propagate_cvjp``. The forward is
the kernel, unchanged; the backward is the VJP of the ``torch.fft``
composition (``ops.asm.propagate_torch``), as the JAX ``custom_vjp`` takes
``jax.vjp`` of its XLA composition, written as the composition's adjoint
(``_adjoint``) so that no part of the forward runs twice: two FFTs for the
field's gradient, one more for the distance's. The JAX package has no
backward kernel, and neither has the port. Every input and output of the
ops is real, so the gradients of a real loss need no convention for
complex cotangents. ``propagate_cuda`` calls the wrappers; under
``torch.no_grad`` the ops save nothing.

Precision modes keep the JAX package's ``set_dft_precision`` names:
``"highest"`` (fp32), ``"high"`` (bf16 hi/lo three-product split, the
default) and ``"bf16"`` (one bf16 product).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import numpy as np
import torch

from style_transfer_based_holographic_imaging_tpu_torch.kernels import _build, library
from style_transfer_based_holographic_imaging_tpu_torch.ops.asm import kz_rel_grid, pad_replicate
from style_transfer_based_holographic_imaging_tpu_torch.utils.misc import static_scalar

__all__ = [
    "asm_const",
    "asm_dynamic",
    "asm_const_plain",
    "asm_dynamic_plain",
    "propagate_cuda",
    "folded_factors",
    "block_factors",
    "split_hi_lo",
    "set_dft_precision",
    "LAUNCHES",
    "reset_launches",
]

_PRECISIONS = ("highest", "high", "bf16")  # index = the kernel's template code
_DFT_PRECISION = "high"

# Launches of each kernel by its wrapper (one per propagate call).
LAUNCHES = {"asm_const": 0, "asm_dynamic": 0}

_SOURCE = "asm_propagate"


def set_dft_precision(precision: str) -> None:
    """Default precision mode: 'highest', 'high' (default) or 'bf16'."""
    global _DFT_PRECISION
    if precision not in _PRECISIONS:
        raise ValueError(f"unknown dft precision {precision!r}")
    _DFT_PRECISION = precision


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------
# Factors and transfer functions (host fp64 -> fp32, as in the JAX package)
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _dft_matrix(n: int):
    """(n, n) fp64 re/im planes of exp(-2 pi i j k / n), angle reduced mod n."""
    j = np.arange(n, dtype=np.int64)
    jk = np.outer(j, j) % n
    ang = -2.0 * np.pi * jk.astype(np.float64) / n
    return np.cos(ang), np.sin(ang)


@functools.lru_cache(maxsize=None)
def folded_factors(n: int, full: int):
    """Factors folding the replicate pad and centre crop into the DFTs.

    With R (full, n) the edge-replication matrix, the padded fft2 is
    ``A x B`` with ``A = F R`` (full, n) and ``B = A^T``; ifft2-then-crop is
    ``C T D`` with ``C = conj(F)[lo:hi, :] / full`` and ``D = C^T``. Built in
    fp64 and cast to fp32. Returns read-only (Are, Aim, Cre, Cim).
    """
    fre, fim = _dft_matrix(full)
    lo = (full - n) // 2
    r = np.zeros((full, n), np.float64)
    r[np.arange(full), np.clip(np.arange(full) - lo, 0, n - 1)] = 1.0
    are, aim = fre @ r, fim @ r
    inv_n = 1.0 / float(full)
    cre = fre[lo : lo + n, :] * inv_n
    cim = -fim[lo : lo + n, :] * inv_n
    out = tuple(m.astype(np.float32) for m in (are, aim, cre, cim))
    for m in out:
        m.setflags(write=False)
    return out


@functools.lru_cache(maxsize=8)
def _factor_tensors(h: int, w: int, device: torch.device):
    """(are, aim, bre, bim, cre, cim, dre, dim) on ``device``, contiguous."""
    fh, fw = 2 * h, 2 * w
    are, aim, cre, cim = folded_factors(h, fh)
    awre, awim, cwre, cwim = folded_factors(w, fw)
    mats = (are, aim, awre.T, awim.T, cre, cim, cwre.T, cwim.T)
    return tuple(torch.tensor(np.ascontiguousarray(m), device=device) for m in mats)


def _pad8(n: int) -> int:
    """Row pitch of a bf16 operand: a multiple of 8 elements (16 bytes), as
    the tensor maps' strides must be."""
    return (n + 7) // 8 * 8


@functools.lru_cache(maxsize=None)
def block_factors(h: int, w: int):
    """The four stages' factors as real blocks, complex re/im stacked along K,
    each stored K-major (one row per output row of its stage), fp32.

    * ``F1`` (2fh, 2h) = [[Ar, -Ai], [Ai, Ar]]: stage 1, on the left of
      [xr; xi], gives [S1r; S1i].
    * ``G2`` (2fw, 2w): stage 2, on the right of [S1r | S1i]; row 2n is
      [Br[:, n], -Bi[:, n]], row 2n+1 [Bi[:, n], Br[:, n]], so the output's
      columns 2n and 2n+1 are T's re and im at column n.
    * ``F3`` (2h, 2fh) = [[Cr, -Ci], [Ci, Cr]]: stage 3 on [Tr; Ti].
    * ``G4`` (2w, 2fw): stage 4 on [U1r | U1i], rows as ``G2``'s with D.

    Built from ``folded_factors``; returns read-only numpy arrays."""
    fh, fw = 2 * h, 2 * w
    are, aim, cre, cim = folded_factors(h, fh)
    # B = Aw^T and D = Cw^T: row n of the right-hand block reads column n of
    # B (D), which is row n of Aw (Cw).
    awre, awim, cwre, cwim = folded_factors(w, fw)

    def left(re, im):
        return np.block([[re, -im], [im, re]])

    def right(re, im):
        out = np.empty((2 * re.shape[0], 2 * re.shape[1]), np.float32)
        out[0::2] = np.concatenate([re, -im], axis=1)
        out[1::2] = np.concatenate([im, re], axis=1)
        return out

    mats = (left(are, aim), right(awre, awim), left(cre, cim), right(cwre, cwim))
    for m in mats:
        m.setflags(write=False)
    return mats


def split_hi_lo(m: torch.Tensor):
    """(hi, lo) bf16 of an fp32 tensor: hi = bf16(m), lo = bf16(m - hi), the
    split of the plain version's ``high`` products."""
    hi = m.to(torch.bfloat16)
    return hi, (m - hi.float()).to(torch.bfloat16)


@functools.lru_cache(maxsize=8)
def _block_factor_tensors(h: int, w: int, device: torch.device):
    """(F1 hi, lo, G2 hi, lo, F3 hi, lo, G4 hi, lo) on ``device``: bf16,
    rows padded to ``_pad8`` with zeros, contiguous."""
    out = []
    for m in block_factors(h, w):
        hi, lo = split_hi_lo(torch.from_numpy(np.array(m)))
        for t in (hi, lo):
            padded = torch.zeros(t.shape[0], _pad8(t.shape[1]), dtype=torch.bfloat16)
            padded[:, : t.shape[1]] = t
            out.append(padded.to(device))
    return tuple(out)


@functools.lru_cache(maxsize=8)
def _kz_tensor(fh: int, fw: int, pixel_size: float, wavelength: float, device: torch.device):
    return torch.tensor(kz_rel_grid(fh, fw, pixel_size=pixel_size, wavelength=wavelength), device=device)


@functools.lru_cache(maxsize=16)
def _const_transfer(fh, fw, d32: float, wavelength, pixel_size, device):
    """(hre, him) of H for one static distance ``d32`` (an fp32 value), the
    global phasor folded in, with the fp32 ops of the JAX const path; built
    on the host, cached on ``device``."""
    kz = torch.tensor(kz_rel_grid(fh, fw, pixel_size=pixel_size, wavelength=wavelength))
    d32 = torch.tensor(d32, dtype=torch.float32)
    phase = d32 * kz
    g_phase = d32 * torch.tensor(2.0 * math.pi / wavelength, dtype=torch.float32)
    c, s = torch.cos(phase), torch.sin(phase)
    gc, gs = torch.cos(g_phase), torch.sin(g_phase)
    return (c * gc - s * gs).to(device), (s * gc + c * gs).to(device)


# --------------------------------------------------------------------------
# Plain PyTorch versions
# --------------------------------------------------------------------------


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _dot(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "highest":
        return torch.matmul(a, b)
    if precision == "bf16":
        return torch.matmul(_bf16(a), _bf16(b))
    ahi, bhi = _bf16(a), _bf16(b)
    alo, blo = _bf16(a - ahi), _bf16(b - bhi)
    return torch.matmul(ahi, bhi) + torch.matmul(ahi, blo) + torch.matmul(alo, bhi)


def _cmm(are, aim, bre, bim, precision):
    """(are + i aim) @ (bre + i bim) as four real products."""
    return (
        _dot(are, bre, precision) - _dot(aim, bim, precision),
        _dot(are, bim, precision) + _dot(aim, bre, precision),
    )


def _plain(xre, xim, factors, precision, transfer, phasor):
    are, aim, bre, bim, cre, cim, dre, dim = factors
    s1re, s1im = _cmm(are, aim, xre, xim, precision)
    sre, sim = _cmm(s1re, s1im, bre, bim, precision)
    hre, him = transfer
    tre = sre * hre - sim * him
    tim = sre * him + sim * hre
    u1re, u1im = _cmm(cre, cim, tre, tim, precision)
    ure, uim = _cmm(u1re, u1im, dre, dim, precision)
    if phasor is None:
        return ure, uim
    gc, gs = phasor
    return ure * gc - uim * gs, ure * gs + uim * gc


def asm_const_plain(xre, xim, distance: float, *, wavelength, pixel_size, precision=None):
    """Plain PyTorch version of ``asm_const`` (same factors, same roundings)."""
    precision = precision or _DFT_PRECISION
    b, h, w = xre.shape
    dev = xre.device
    transfer = _const_transfer(
        2 * h, 2 * w, float(np.float32(distance)), wavelength, pixel_size, dev
    )
    return _plain(xre, xim, _factor_tensors(h, w, dev), precision, transfer, None)


def asm_dynamic_plain(xre, xim, dist, *, wavelength, pixel_size, precision=None):
    """Plain PyTorch version of ``asm_dynamic``; ``dist`` is ``(B,)`` fp32."""
    precision = precision or _DFT_PRECISION
    b, h, w = xre.shape
    dev = xre.device
    kz = _kz_tensor(2 * h, 2 * w, pixel_size, wavelength, dev)
    d = dist.reshape(b, 1, 1)
    phase = d * kz
    g = d * float(np.float32(2.0 * math.pi / wavelength))
    return _plain(
        xre,
        xim,
        _factor_tensors(h, w, dev),
        precision,
        (torch.cos(phase), torch.sin(phase)),
        (torch.cos(g), torch.sin(g)),
    )


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_COMMON = [_I, _P, _P, _I, _I, _I, _I, _I] + [_P] * 8  # precision .. x, dims, factors
_SCRATCH_OUT = [_P] * 8 + [_P]                         # s1, t, u1, y planes, stream


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = _build.load(_SOURCE)
    lib.asm_const.argtypes = _COMMON + [_P, _P] + _SCRATCH_OUT
    lib.asm_const.restype = ctypes.c_int
    lib.asm_dynamic.argtypes = _COMMON + [_P, _P, ctypes.c_float] + _SCRATCH_OUT
    lib.asm_dynamic.restype = ctypes.c_int
    return lib


def _check_planes(xre: torch.Tensor, xim: torch.Tensor) -> None:
    for name, t in (("xre", xre), ("xim", xim)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.ndim != 3:
            raise ValueError(f"{name} must be (B, H, W), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if xre.shape != xim.shape or xre.device != xim.device:
        raise ValueError("xre and xim must share shape and device")
    b, h, w = xre.shape
    if b < 1 or h % 2 or w % 2 or min(h, w) < 16 or max(h, w) > 256:
        raise ValueError(f"unsupported field shape {tuple(xre.shape)}: even H/W in [16, 256]")


def _launch_buffers(xre: torch.Tensor):
    """Scratch for S1, T and U1 (re and im, or bf16 hi and lo) and the output
    planes. Each scratch buffer holds, per image, the larger of the fp32
    plane of ``highest`` and the bf16 operand plane of the other modes (K
    padded to 8); U1's also holds x^T, which the tensor-core path keeps there
    until stage 3."""
    b, h, w = xre.shape
    fh, fw = 2 * h, 2 * w
    e = functools.partial(torch.empty, dtype=torch.float32, device=xre.device)
    half = lambda n: (n + 1) // 2  # noqa: E731  (bf16 elements in fp32 slots)
    s1 = max(fh * w, half(fh * _pad8(2 * w)))
    t = max(fh * fw, half(fw * _pad8(2 * fh)))
    u1 = max(h * fw, half(h * _pad8(2 * fw)), half(w * _pad8(2 * h)))
    scratch = (e(b, s1), e(b, s1), e(b, t), e(b, t), e(b, u1), e(b, u1))
    return scratch, e(b, h, w), e(b, h, w)


def _factors_for(precision: str, h: int, w: int, device: torch.device):
    """The eight factor planes the C entry point takes in ``precision``."""
    if precision == "highest":
        return _factor_tensors(h, w, device)
    return _block_factor_tensors(h, w, device)


def _named(kernel: str):
    """A profiler region named after the kernel while a profiler records (a
    ctypes launch is otherwise unnamed in its trace); nothing otherwise, so
    that an unprofiled launch pays no host time for it."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(kernel)
    return contextlib.nullcontext()


def _precision(precision) -> str:
    precision = precision or _DFT_PRECISION
    if precision not in _PRECISIONS:
        raise ValueError(f"unknown dft precision {precision!r}")
    return precision


def _asm_const_cpu(xre: torch.Tensor, xim: torch.Tensor, distance: float, wavelength: float,
                   pixel_size: float, precision: str) -> tuple[torch.Tensor, torch.Tensor]:
    return asm_const_plain(
        xre, xim, distance, wavelength=wavelength, pixel_size=pixel_size, precision=precision)


def _asm_const_cuda(xre, xim, distance, wavelength, pixel_size, precision):
    xre, xim = xre.contiguous(), xim.contiguous()
    b, h, w = xre.shape
    dev = xre.device
    factors = _factors_for(precision, h, w, dev)
    hre, him = _const_transfer(
        2 * h, 2 * w, float(np.float32(distance)), wavelength, pixel_size, dev
    )
    scratch, yre, yim = _launch_buffers(xre)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev), _named("asm_const"):
        status = _lib().asm_const(
            _PRECISIONS.index(precision),
            xre.data_ptr(), xim.data_ptr(), b, h, w, 2 * h, 2 * w,
            *(m.data_ptr() for m in factors),
            hre.data_ptr(), him.data_ptr(),
            *(s.data_ptr() for s in scratch),
            yre.data_ptr(), yim.data_ptr(),
            stream,
        )
    _build.check_status(status, "asm_const")
    LAUNCHES["asm_const"] += 1
    return yre, yim


def _asm_dynamic_cpu(xre: torch.Tensor, xim: torch.Tensor, dist: torch.Tensor, wavelength: float,
                     pixel_size: float, precision: str) -> tuple[torch.Tensor, torch.Tensor]:
    return asm_dynamic_plain(
        xre, xim, dist, wavelength=wavelength, pixel_size=pixel_size, precision=precision)


def _asm_dynamic_cuda(xre, xim, dist, wavelength, pixel_size, precision):
    xre, xim, dist = xre.contiguous(), xim.contiguous(), dist.contiguous()
    b, h, w = xre.shape
    dev = xre.device
    factors = _factors_for(precision, h, w, dev)
    kz = _kz_tensor(2 * h, 2 * w, pixel_size, wavelength, dev)
    scratch, yre, yim = _launch_buffers(xre)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev), _named("asm_dynamic"):
        status = _lib().asm_dynamic(
            _PRECISIONS.index(precision),
            xre.data_ptr(), xim.data_ptr(), b, h, w, 2 * h, 2 * w,
            *(m.data_ptr() for m in factors),
            kz.data_ptr(), dist.data_ptr(), float(np.float32(2.0 * math.pi / wavelength)),
            *(s.data_ptr() for s in scratch),
            yre.data_ptr(), yim.data_ptr(),
            stream,
        )
    _build.check_status(status, "asm_dynamic")
    LAUNCHES["asm_dynamic"] += 1
    return yre, yim


def _planes_like(xre, xim, *_):
    return torch.empty_like(xre), torch.empty_like(xim)


def asm_const(xre, xim, distance: float, *, wavelength, pixel_size, precision=None):
    """Propagate ``(B, H, W)`` fp32 re/im planes by one static distance
    (metres), replicate-padded 2x. Returns ``(yre, yim)``; differentiable in
    the planes. The op ``holostyle::asm_const``: the kernel on a card, the
    plain version on the CPU."""
    precision = _precision(precision)
    _check_planes(xre, xim)
    return _ASM_CONST(xre, xim, float(distance), float(wavelength), float(pixel_size), precision)


def asm_dynamic(xre, xim, dist, *, wavelength, pixel_size, precision=None):
    """Propagate ``(B, H, W)`` fp32 re/im planes, image ``i`` by ``dist[i]``
    metres (``dist`` a ``(B,)`` fp32 tensor). Returns ``(yre, yim)``;
    differentiable in the planes and ``dist``. The op
    ``holostyle::asm_dynamic``."""
    precision = _precision(precision)
    _check_planes(xre, xim)
    b = xre.shape[0]
    if dist.dtype != torch.float32 or tuple(dist.shape) != (b,) or not dist.is_contiguous():
        raise ValueError(f"dist must be a contiguous float32 ({b},) tensor")
    if dist.device != xre.device:
        raise ValueError("dist must lie on the field's device")
    return _ASM_DYNAMIC(xre, xim, dist, float(wavelength), float(pixel_size), precision)


# --------------------------------------------------------------------------
# Gradients
# --------------------------------------------------------------------------


def _fold_edges(g: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """The adjoint of the replicate pad of ``n // 2`` along ``dim`` (length
    ``2 n`` to ``n``): each padded pixel's value added onto the edge pixel
    it copies."""
    p = n // 2
    core = g.narrow(dim, p, n).clone()
    core.select(dim, 0).add_(g.narrow(dim, 0, p).sum(dim))
    core.select(dim, n - 1).add_(g.narrow(dim, p + n, p).sum(dim))
    return core


def _adjoint(ctx, gre, gim, dist, x=None, y=None):
    """The VJP of ``propagate_torch`` (replicate pad P, fft2, x H, ifft2,
    x g, crop C) written as its adjoint, for the cotangents (gre, gim) of
    (yre, yim) of ``(B, H, W)`` images and ``dist`` a host float or a
    ``(B,)`` tensor. The field's gradient is ``P^T ifft2(conj(H) E)`` with
    ``E = fft2(conj(g) C^T gy)``; with ``x = (xre, xim)`` and the forward's
    output ``y = (yre, yim)`` also the distance's: the transfer function's
    term ``-sum Im(conj(E) H fft2(P x)) kz / N`` over each image's padded
    spectrum (N its size), and the global phasor's ``-k0 sum Im(conj(gy) y)``
    over the image, its equal by Parseval. That second term is taken where
    the cotangent was made: a loss of ``|y|`` gives ``gy`` parallel to ``y``
    pixel by pixel, so the sum is zero up to one rounding a pixel, while the
    spectral sum cancels FFT rounding to the same zero and multiplies what is
    left by k0 (1.2e7 rad/m at 532 nm), 2-6 % of an MNIST refine's distance
    gradient in fp32. None of the forward is re-run: the field's gradient
    needs none of it, the distance's one FFT of the padded input.
    Returns ``(gxre or None, gxim or None, gdist or None)``."""
    b, h, w = gre.shape
    dev = gre.device
    if type(gre) is torch.Tensor:
        kz = _kz_tensor(2 * h, 2 * w, ctx.pixel_size, ctx.wavelength, dev)
    else:
        # A tracing subclass (a fake or functional tensor, while a graph of
        # the backward is captured): a fresh constant, never a cached one,
        # at the traced shape (the grid is host data of that shape).
        kz = torch.tensor(kz_rel_grid(2 * int(h), 2 * int(w), pixel_size=ctx.pixel_size,
                                      wavelength=ctx.wavelength), device=dev)
    k0 = float(np.float32(2.0 * math.pi / ctx.wavelength))
    d = torch.as_tensor(dist, dtype=torch.float32, device=dev)
    d = d.reshape(b, 1, 1) if d.dim() else d
    phase, g_phase = d * kz, d * k0
    transfer = torch.complex(torch.cos(phase), torch.sin(phase))
    g_conj = torch.complex(torch.cos(g_phase), -torch.sin(g_phase))
    e = gre.new_zeros((b, 2 * h, 2 * w), dtype=torch.complex64)
    e[:, h // 2 : h // 2 + h, w // 2 : w // 2 + w] = torch.complex(gre, gim) * g_conj
    e_hat = torch.fft.fft2(e)
    gxre = gxim = gdist = None
    if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
        gx = torch.fft.ifft2(torch.conj(transfer) * e_hat)
        gxre = _fold_edges(_fold_edges(gx.real, w, 2), h, 1)
        gxim = _fold_edges(_fold_edges(gx.imag, w, 2), h, 1)
    if x is not None:
        spectrum = torch.fft.fft2(pad_replicate(torch.complex(*x), h // 2, w // 2))
        t = torch.imag(torch.conj(e_hat) * transfer * spectrum)
        n = float(4 * h * w)
        yre, yim = y
        gdist = -(t * kz).sum((1, 2)) / n - k0 * (gre * yim - gim * yre).sum((1, 2))
    return gxre, gxim, gdist


def _const_setup(ctx, inputs, output):
    _, _, ctx.distance, ctx.wavelength, ctx.pixel_size, _ = inputs


def _const_backward(ctx, gre, gim):
    gxre, gxim, _ = _adjoint(ctx, gre, gim, ctx.distance)
    return gxre, gxim, None, None, None, None


def _dynamic_setup(ctx, inputs, output):
    xre, xim, dist, ctx.wavelength, ctx.pixel_size, _ = inputs
    # The field and the output are needed only for the distance's gradient.
    ctx.save_for_backward(dist, *((xre, xim, *output) if ctx.needs_input_grad[2] else ()))


def _dynamic_backward(ctx, gre, gim):
    dist, *xy = ctx.saved_tensors
    x, y = (tuple(xy[:2]), tuple(xy[2:])) if xy else (None, None)
    return _adjoint(ctx, gre, gim, dist, x, y) + (None, None, None)


# The ops: the kernel forward on a card, the plain version on the CPU, the
# adjoint backward on both (the counterparts of the JAX package's
# ``_propagate_const_cvjp`` and ``_propagate_cvjp``).
_ASM_CONST = library.kernel_op("asm_const", _asm_const_cpu, _asm_const_cuda, _planes_like,
                               backward=_const_backward, setup_context=_const_setup)
_ASM_DYNAMIC = library.kernel_op("asm_dynamic", _asm_dynamic_cpu, _asm_dynamic_cuda, _planes_like,
                                 backward=_dynamic_backward, setup_context=_dynamic_setup)


def propagate_cuda(field: torch.Tensor, distance, *, wavelength, pixel_size, precision=None):
    """Complex ``(..., H, W)`` field through the kernels: a host-scalar
    distance takes ``asm_const``, anything else ``asm_dynamic`` with the
    distance broadcast to the leading axes. Differentiable in the field and
    a tensor distance, through the ops' backward."""
    lead = tuple(field.shape[:-2])
    h, w = field.shape[-2], field.shape[-1]
    b = int(np.prod(lead)) if lead else 1
    flat = field.reshape(b, h, w)
    xre = flat.real.float().contiguous()
    xim = flat.imag.float().contiguous()
    kw = dict(wavelength=wavelength, pixel_size=pixel_size, precision=precision)
    static_d = static_scalar(distance)
    if static_d is not None:
        yre, yim = asm_const(xre, xim, static_d, **kw)
    else:
        dist = torch.as_tensor(distance, dtype=torch.float32, device=field.device)
        dist = dist.broadcast_to(lead + (1, 1)).reshape(b).contiguous()
        yre, yim = asm_dynamic(xre, xim, dist, **kw)
    return torch.complex(yre, yim).reshape(field.shape)
