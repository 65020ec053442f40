"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and the CUDA toolkit (the kernels are compiled
with ``nvcc`` at first use); elsewhere they skip. On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerance on max|err| / max|plain|: for the ASM kernels the JAX package's
budgets per precision mode (1e-5 highest, 1e-4 high, 2e-2 bf16); kernel and
plain version round alike and differ only in the order of their fp32 sums.
For the conv stacks, the halo tail and the border ring: 1e-5 in fp32
(summation order);
1e-2 in bf16, where a value that the other summation order puts on a bf16
rounding boundary rounds the other way (2^-8 relative) and carries into the
next layer.
"""

import math

import pytest
import torch

from style_transfer_based_holographic_imaging_tpu_torch.kernels import (
    asm_cuda,
    conv_stack,
    halo_conv,
    reflect_border,
)
from style_transfer_based_holographic_imaging_tpu_torch.ops import asm as torch_asm

pytestmark = pytest.mark.cuda

KW = dict(wavelength=532e-9, pixel_size=1.5e-6)
BUDGETS = {"highest": 1e-5, "high": 1e-4, "bf16": 2e-2}
CONV_BUDGETS = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _planes(b, h, w, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(b, h, w, generator=g).to(device), torch.rand(b, h, w, generator=g).to(device))


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("precision", ["highest", "high", "bf16"])
@pytest.mark.parametrize("shape", [(3, 128, 128), (2, 48, 64), (1, 16, 16)])
def test_kernels_match_plain_versions(card, precision, shape):
    b, h, w = shape
    xre, xim = _planes(b, h, w, card)
    dist = torch.linspace(-8e-4, 8e-4, b, device=card)
    for run, plain in (
        (asm_cuda.asm_const, asm_cuda.asm_const_plain),
        (asm_cuda.asm_dynamic, asm_cuda.asm_dynamic_plain),
    ):
        d = -2e-4 if run is asm_cuda.asm_const else dist
        y = torch.complex(*run(xre, xim, d, precision=precision, **KW))
        p = torch.complex(*plain(xre, xim, d, precision=precision, **KW))
        torch.cuda.synchronize()
        assert _rel(y, p) < BUDGETS[precision]


def test_propagate_auto_takes_the_kernels_on_the_card(card):
    xre, xim = _planes(4, 128, 128, card)
    field = torch.complex(xre, xim)[:, None]
    asm_cuda.reset_launches()
    const = torch_asm.propagate(field, -2e-4, **KW)
    dyn = torch_asm.propagate(field, torch.full((4, 1, 1, 1), -2e-4, device=card), **KW)
    assert asm_cuda.LAUNCHES == {"asm_const": 1, "asm_dynamic": 1}
    exact = torch_asm.propagate_torch(field, -2e-4, **KW)
    assert _rel(const, exact) < BUDGETS["high"]
    assert _rel(dyn, const) < 1e-5


def test_wrapper_rejects_tensors_on_two_devices(card):
    xre, xim = _planes(2, 32, 32, card)
    with pytest.raises(ValueError):
        asm_cuda.asm_const(xre, xim.cpu(), -2e-4, **KW)
    with pytest.raises(ValueError):
        asm_cuda.asm_dynamic(xre, xim, torch.zeros(2), **KW)


def _stack_args(card, dtype, c, layers, b=2, h=32, w=24, seed=0):
    g = torch.Generator().manual_seed(seed)
    args = [torch.rand(b, c, h, w, generator=g).to(card, dtype)]
    for o in layers:
        k = torch.randn(o, c, 3, 3, generator=g) * (2.0 / (9 * c)) ** 0.5
        args += [k.to(card, dtype), (0.01 * torch.randn(o, generator=g)).to(card)]
        c = o
    return args


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("c_in", [1, 3])
def test_encoder_head_matches_plain_version(card, dtype, c_in):
    args = _stack_args(card, dtype, c_in, (64, 64))
    conv_stack.reset_launches()
    y = conv_stack.fused_encoder_head(*args)
    p = conv_stack.encoder_head_plain(*args)
    torch.cuda.synchronize()
    assert conv_stack.LAUNCHES["fused_encoder_head"] == 1
    assert y.dtype == dtype and y.shape == p.shape == (2, 64, 16, 12)
    assert _rel(y.float(), p.float()) < CONV_BUDGETS[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 64, 32, 24), (1, 16, 20, 12)])
def test_conv_tail_matches_plain_version(card, dtype, shape):
    b, c, h, w = shape
    args = _stack_args(card, dtype, c, (c, c, 2), b=b, h=h, w=w)
    conv_stack.reset_launches()
    y = conv_stack.fused_conv_tail(*args)
    p = conv_stack.conv_tail_plain(*args)
    torch.cuda.synchronize()
    assert conv_stack.LAUNCHES["fused_conv_tail"] == 1
    assert y.dtype == dtype and y.shape == p.shape == (b, 2, h, w)
    assert _rel(y.float(), p.float()) < CONV_BUDGETS[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 64, 128, 128, 64), (3, 512, 16, 16, 256), (2, 3, 9, 70, 5)])
def test_border_lines_match_plain_version(card, dtype, shape):
    b, c, h, w, o = shape
    g = torch.Generator().manual_seed(1)
    x = torch.randn(b, c, h, w, generator=g).to(card, dtype)
    k = (torch.randn(o, c, 3, 3, generator=g) * 0.1).to(card, dtype)
    reflect_border.reset_launches()
    rows, cols = reflect_border.border_lines(x, k)
    prows, pcols = reflect_border.border_lines_plain(x, k)
    torch.cuda.synchronize()
    assert reflect_border.LAUNCHES["border_lines"] == 1
    assert rows.dtype == dtype and rows.shape == (b, o, 2, w) and cols.shape == (b, o, h, 2)
    assert _rel(rows.float(), prows.float()) < CONV_BUDGETS[dtype]
    assert _rel(cols.float(), pcols.float()) < CONV_BUDGETS[dtype]


HALO_KERNELS = {"halo_conv_tail": halo_conv.halo_conv_tail,
                "halo_conv_tail_static": halo_conv.halo_conv_tail_static}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", sorted(HALO_KERNELS))
@pytest.mark.parametrize("shape,bh", [
    ((2, 64, 128, 128), 30), ((2, 64, 128, 128), 60), ((1, 16, 40, 20), 16),
    ((3, 8, 56, 33), 24), ((2, 8, 24, 16), 8),
])
def test_halo_tail_matches_plain_version(card, dtype, name, shape, bh):
    b, c, h, w = shape
    args = _stack_args(card, dtype, c, (c, c, 2), b=b, h=h, w=w)
    halo_conv.reset_launches()
    y = HALO_KERNELS[name](*args, bh=bh)
    p = halo_conv.halo_conv_tail_plain(*args, bh=bh)
    torch.cuda.synchronize()
    assert halo_conv.LAUNCHES[name] == 1 and sum(halo_conv.LAUNCHES.values()) == 1
    assert y.dtype == dtype and y.shape == p.shape == (b, 2, h, w)
    assert _rel(y.float(), p.float()) < CONV_BUDGETS[dtype]
    if h % 2 == 0 and w % 2 == 0:  # what the fused tail takes: the same rows
        e = halo_conv.EDGE
        fused = conv_stack.fused_conv_tail(*args)[:, :, e:-e]
        assert _rel(y[:, :, e:-e].float(), fused.float()) < CONV_BUDGETS[dtype]


def test_static_halo_kernel_takes_its_instantiated_block_heights(card):
    args = _stack_args(card, torch.float32, 8, (8, 8, 2), b=1, h=48, w=16)
    with pytest.raises(ValueError):  # 40 interior rows in blocks of 20: no instance
        halo_conv.halo_conv_tail_static(*args, bh=20)
    y = halo_conv.halo_conv_tail(*args, bh=20)
    p = halo_conv.halo_conv_tail_plain(*args, bh=20)
    torch.cuda.synchronize()
    assert _rel(y, p) < CONV_BUDGETS[torch.float32]


def _bf16_ulp(ref):
    return 2.0 ** (math.floor(math.log2(float(ref.abs().max()))) - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("c", [64, 16])
def test_halo_tail_on_the_card_matches_the_cpu(card, dtype, c):
    """The card's strips are cuDNN's convs in x's dtype, the CPU's fp32 convs
    rounded once (the version tests/test_torch_halo_conv.py holds to JAX):
    bf16 edge rows and the whole reference within four ulps of max|ref|."""
    args = _stack_args(card, dtype, c, (c, c, 2), b=2, h=128, w=128, seed=c)
    cpu_args = [a.cpu() for a in args]
    ref = conv_stack.conv_tail_reference(*cpu_args).float()
    card_ref = conv_stack.conv_tail_reference(*args).float().cpu()
    plain = halo_conv.halo_conv_tail_plain(*cpu_args, bh=30).float()
    e = halo_conv.EDGE
    edges = torch.cat([torch.arange(e), torch.arange(128 - e, 128)])
    for fn in HALO_KERNELS.values():
        y = fn(*args, bh=30).float().cpu()
        assert _rel(y[:, :, e:-e], plain[:, :, e:-e]) < CONV_BUDGETS[dtype]
        edge_err = float((y[:, :, edges] - plain[:, :, edges]).abs().max())
        if dtype == torch.bfloat16:
            assert edge_err <= 4 * _bf16_ulp(plain)
        else:
            assert edge_err / float(plain.abs().max()) < CONV_BUDGETS[dtype]
    if dtype == torch.bfloat16:
        assert float((card_ref - ref).abs().max()) <= 4 * _bf16_ulp(ref)
    else:
        assert _rel(card_ref, ref) < CONV_BUDGETS[dtype]
