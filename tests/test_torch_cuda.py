"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and the CUDA toolkit (the kernels are compiled
with ``nvcc`` at first use); elsewhere they skip. On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerance on max|err| / max|plain|: for the ASM kernels the JAX package's
budgets per precision mode (1e-5 highest, 1e-4 high, 2e-2 bf16); kernel and
plain version round alike and differ only in the order of their fp32 sums.
The gradients of the ops ``asm_const`` and ``asm_dynamic`` (the kernels forward, the
composition's adjoint in ``torch.fft`` backward) against ``propagate_torch``
autograd: rtol 1e-3 of the largest gradient, the JAX package's gradient
budget.
For the conv stacks, the halo tail and the border ring: 1e-5 in fp32
(summation order);
1e-2 in bf16, where a value that the other summation order puts on a bf16
rounding boundary rounds the other way (2^-8 relative) and carries into the
next layer.
Training: the op ``reflect_border.border_lines`` (the ring kernel forward, the
plain version's VJP backward) gives the gradients of ``border_lines_plain``
autograd (1e-5 of max: the forward's fp32 summation order); one train
step on the card against the same step on the CPU, width 0.25, 64^2, B = 2:
aux terms 1e-4 relative; the generator's and discriminator's gradients of
both within 2e-3 of each leaf's max of a float64 evaluation on the card;
params, EMA and discriminator within 1e-4 of each leaf's max plus the
spread of Adam's first step, lr g/(|g| + eps), over the gradients within
the leaf's measured fp32 noise of the float64 one (up to 2 lr where the
sign is free; ``chip_smoke.py`` says more).
Each kernel is a ``holostyle::`` custom op: ``torch.library.opcheck`` passes
for each on CUDA tensors. A ``torch.export`` artifact whose refocus is the
``asm_const`` op answers as the live path does, bit for bit.
The served path: the HTTP service's answers equal the direct retrieval call
on the same padded batches, bit for bit (same shapes, same kernels); the
pinned prefetch gives the same batches, in order, as a blocking
``.to("cuda")``, re-raises its producer's error and lets the producer go
when the consumer stops early.
"""

import dataclasses
import math
import os
import threading

import numpy as np

import pytest
import torch

from style_transfer_based_holographic_imaging_tpu_torch.kernels import (
    asm_cuda,
    conv_stack,
    halo_conv,
    reflect_border,
)
from style_transfer_based_holographic_imaging_tpu_torch.config import ExperimentConfig, PhysicsConfig
from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite, prefetch_to_device
from style_transfer_based_holographic_imaging_tpu_torch.interop import (
    load_release_weights,
    load_style_vector,
)
from style_transfer_based_holographic_imaging_tpu_torch.models import (
    PatchDiscriminator,
    StyleTransferNet,
    init_net_params,
    init_params,
)
from style_transfer_based_holographic_imaging_tpu_torch.ops import asm as torch_asm
from style_transfer_based_holographic_imaging_tpu_torch.ops import holo_forward
from style_transfer_based_holographic_imaging_tpu_torch.pipelines import (
    RetrievalService,
    make_retrieval_fn,
    physics_refine,
    retrieve_remote,
    serve_forever,
)
from style_transfer_based_holographic_imaging_tpu_torch.train import (
    TrainStep,
    create_train_state,
    tv_loss,
)

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


# Shapes whose tensor-core tiles are ragged: (2, 48, 80) as asked of the
# kernels' M; (2, 40, 56) has M, N and K off a multiple of 64 in all four
# stages (M = 160, 80, 80, 40); (2, 18, 30) pads every operand row to 8.
RAGGED_SHAPES = [(2, 48, 80), (2, 40, 56), (2, 18, 30)]


@pytest.mark.parametrize("precision", ["highest", "high", "bf16"])
@pytest.mark.parametrize("shape", RAGGED_SHAPES)
def test_kernels_match_plain_versions_on_ragged_tiles(card, precision, shape):
    b, h, w = shape
    xre, xim = _planes(b, h, w, card, seed=h + w)
    dist = torch.linspace(-8e-4, 8e-4, b, device=card)
    for run, plain, d in (
        (asm_cuda.asm_const, asm_cuda.asm_const_plain, -2e-4),
        (asm_cuda.asm_dynamic, asm_cuda.asm_dynamic_plain, dist),
    ):
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


GRAD_BUDGET = 1e-3


def _grads(fn, xre, xim, dist, weights):
    inputs = [xre.clone().requires_grad_(), xim.clone().requires_grad_()]
    if dist is not None:
        inputs.append(dist.clone().requires_grad_())
    yre, yim = fn(*inputs)
    loss = (weights[0] * yre + weights[1] * yim * yim + 0.3 * (yre * yre + yim * yim) ** 2).sum()
    return torch.autograd.grad(loss, inputs)


def _fft(xre, xim, d=-2e-4):
    d = d.reshape(-1, 1, 1) if isinstance(d, torch.Tensor) else d
    y = torch_asm.propagate_torch(torch.complex(xre, xim), d, **KW)
    return y.real, y.imag


@pytest.mark.parametrize("precision", ["high", "highest"])
@pytest.mark.parametrize("b", [5, 256])
@pytest.mark.parametrize("kind", ["const", "dynamic"])
def test_function_gradients_match_torch_fft_autograd(card, kind, b, precision):
    xre, xim = _planes(b, 128, 128, card, seed=b)
    weights = torch.randn(2, b, 128, 128, generator=torch.Generator().manual_seed(b)).to(card)
    wl, px = KW["wavelength"], KW["pixel_size"]
    if kind == "const":
        fn, dist = (lambda xr, xi: asm_cuda.asm_const(
            xr, xi, -2e-4, wavelength=wl, pixel_size=px, precision=precision)), None
    else:
        dist = torch.linspace(-8e-4, 8e-4, b, device=card)
        fn = lambda xr, xi, d: asm_cuda.asm_dynamic(  # noqa: E731
            xr, xi, d, wavelength=wl, pixel_size=px, precision=precision)
    asm_cuda.reset_launches()
    got = _grads(fn, xre, xim, dist, weights)
    assert asm_cuda.LAUNCHES["asm_" + kind] == 1
    ref = _grads(_fft, xre, xim, dist, weights)
    torch.cuda.synchronize()
    assert len(got) == (2 if kind == "const" else 3)
    for g, r in zip(got, ref):
        assert float(r.abs().max()) > 0
        assert _rel(g, r) < GRAD_BUDGET


def _refine_loss_grads(amp, phase, d, meas, backend):
    """Gradients of data residual + TV through holo_forward, and of the TV
    term alone, for (phase, d)."""
    physics = PhysicsConfig()
    phase, d = phase.clone().requires_grad_(), d.clone().requires_grad_()
    synth = holo_forward(amp, phase, d, physics, asm_backend=backend)
    data = torch.mean((torch.sqrt(torch.clamp(synth, min=0.0)) - meas) ** 2)
    tv = 5e-3 * tv_loss(phase) / phase.shape[0]
    total = torch.autograd.grad(data + tv, (phase, d), retain_graph=True)
    return total, torch.autograd.grad(tv, phase)[0]


@pytest.fixture
def dft_precision():
    yield asm_cuda.set_dft_precision
    asm_cuda.set_dft_precision("high")


@pytest.mark.parametrize("precision", ["high", "highest"])
@pytest.mark.parametrize("backend", ["auto", "cuda"])
def test_refine_loss_has_its_data_gradient_on_the_card(card, backend, precision, dft_precision):
    """The fault of the port before the Functions: on a CUDA tensor the
    propagator's output had no grad_fn, so a loss of data residual plus TV
    gave the TV gradient alone. The phase's data gradient must be nonzero
    and the torch backend's. The distance's is held in ``highest``: it sums
    the residual, which the ``high`` forward's rounding (1e-5 of the field)
    moves by about 3e-3 of the gradient (the plain version on the CPU)."""
    dft_precision(precision)
    g = torch.Generator().manual_seed(0)
    b = 4
    phase = torch.rand(b, 1, 128, 128, generator=g).to(card)
    amp = torch.full_like(phase, 0.6)
    d = torch.tensor([0.4, 0.5, 0.6, 0.7], device=card).reshape(b, 1, 1, 1)
    meas = torch.sqrt(holo_forward(amp, phase + 0.1 * torch.rand(phase.shape, generator=g).to(card),
                                   d, PhysicsConfig(), asm_backend="torch"))
    asm_cuda.reset_launches()
    (g_phase, g_d), g_tv = _refine_loss_grads(amp, phase, d, meas, backend)
    assert asm_cuda.LAUNCHES["asm_dynamic"] == 1
    (r_phase, r_d), r_tv = _refine_loss_grads(amp, phase, d, meas, "torch")
    torch.cuda.synchronize()
    data, ref_data = g_phase - g_tv, r_phase - r_tv
    assert float(ref_data.abs().max()) > 10 * float((g_tv - r_tv).abs().max())
    assert _rel(data, ref_data) < GRAD_BUDGET
    if precision == "highest":
        assert _rel(g_d, r_d) < GRAD_BUDGET


def test_physics_refine_on_the_card_matches_the_torch_backend(card):
    """Ten refinement steps with the kernel forward against the same steps
    through torch.fft on the card: the per-sample residuals within 1e-3."""
    g = torch.Generator().manual_seed(1)
    phase = torch.rand(3, 1, 64, 64, generator=g).to(card)
    amp = torch.full_like(phase, 0.6)
    d = torch.tensor([0.45, 0.6, 0.75], device=card).reshape(3, 1, 1, 1)
    meas = torch.sqrt(holo_forward(amp, phase, d, PhysicsConfig(), asm_backend="torch"))
    start = phase + 0.2 * torch.randn(phase.shape, generator=g).to(card)
    kw = dict(steps=10, optimize_amp=False, device=card)
    asm_cuda.reset_launches()
    got = physics_refine(amp, start, d, meas, PhysicsConfig(), **kw)
    assert asm_cuda.LAUNCHES["asm_dynamic"] == 11
    ref = physics_refine(amp, start, d, meas, PhysicsConfig(), asm_backend="torch", **kw)
    assert float((got["residual"] - ref["residual"]).abs().max()) < 1e-3
    assert float(got["residual"].mean()) < 0.8 * float(
        torch.sqrt(((torch.sqrt(holo_forward(amp, start, d, PhysicsConfig())) - meas) ** 2).mean()))


def _stack_args(card, dtype, c, layers, b=2, h=32, w=24, seed=0):
    g = torch.Generator().manual_seed(seed)
    args = [torch.rand(b, c, h, w, generator=g).to(card, dtype)]
    for o in layers:
        k = torch.randn(o, c, 3, 3, generator=g) * (2.0 / (9 * c)) ** 0.5
        args += [k.to(card, dtype), (0.01 * torch.randn(o, generator=g)).to(card)]
        c = o
    return args


# The head's shapes (B, width, H, W): the releases' widths (64 flagship, 48
# `balanced`, 32 `fast`, 24 `turbo`, 16 `ultra`), H and W off the bf16
# kernel's 16 x 32 pre-pool tile, and the flagship's 128^2.
HEAD_SHAPES = [(2, 64, 32, 24), (2, 16, 20, 34), (2, 24, 34, 20), (2, 48, 20, 34),
               (2, 32, 36, 40), (1, 64, 128, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("c_in", [1, 3])
@pytest.mark.parametrize("shape", HEAD_SHAPES)
def test_encoder_head_matches_plain_version(card, dtype, c_in, shape):
    b, width, h, w = shape
    args = _stack_args(card, dtype, c_in, (width, width), b=b, h=h, w=w)
    conv_stack.reset_launches()
    y = conv_stack.fused_encoder_head(*args)
    p = conv_stack.encoder_head_plain(*args)
    torch.cuda.synchronize()
    assert conv_stack.LAUNCHES["fused_encoder_head"] == 1
    # Every release's width runs the bf16 head on the tensor cores.
    assert conv_stack.TC_LAUNCHES["fused_encoder_head"] == (dtype == torch.bfloat16)
    assert y.dtype == dtype and y.shape == p.shape == (b, width, h // 2, w // 2)
    assert _rel(y.float(), p.float()) < CONV_BUDGETS[dtype]


# The tail's shapes: the widths of the releases' tails (64 flagship, 48
# `balanced`, 24 `turbo`, 16 `ultra`), H and W off the 16 x 16 tile (20,
# 12, 34: the tail takes H and W even, as the JAX package's does) and the
# flagship's 128^2.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 64, 32, 24), (1, 16, 20, 12), (2, 24, 32, 24),
                                   (2, 48, 32, 24), (2, 16, 20, 34), (2, 64, 128, 128)])
def test_conv_tail_matches_plain_version(card, dtype, shape):
    b, c, h, w = shape
    args = _stack_args(card, dtype, c, (c, c, 2), b=b, h=h, w=w)
    conv_stack.reset_launches()
    y = conv_stack.fused_conv_tail(*args)
    p = conv_stack.conv_tail_plain(*args)
    torch.cuda.synchronize()
    assert conv_stack.LAUNCHES["fused_conv_tail"] == 1
    assert conv_stack.TC_LAUNCHES["fused_conv_tail"] == (dtype == torch.bfloat16)
    assert y.dtype == dtype and y.shape == p.shape == (b, 2, h, w)
    assert _rel(y.float(), p.float()) < CONV_BUDGETS[dtype]


# Stacks wider than one 64-channel block a layer (width 1.25 and 2.0 nets):
# in bf16 the tensor-core bodies' weights outgrow shared memory there, so
# both run the SIMT body; (kernel, B, C, widths, H, W).
WIDE_STACKS = [("fused_encoder_head", 2, 1, (80, 80), 20, 34),
               ("fused_encoder_head", 1, 3, (128, 128), 32, 24),
               ("fused_conv_tail", 2, 80, (80, 80, 2), 20, 34),
               ("fused_conv_tail", 1, 128, (128, 128, 2), 32, 24)]
PLAIN = {"fused_encoder_head": conv_stack.encoder_head_plain,
         "fused_conv_tail": conv_stack.conv_tail_plain}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", WIDE_STACKS, ids=lambda c: f"{c[0]}-{c[3][0]}")
def test_wide_stacks_run_the_simt_body(card, dtype, case):
    name, b, c, widths, h, w = case
    args = _stack_args(card, dtype, c, widths, b=b, h=h, w=w)
    conv_stack.reset_launches()
    y = getattr(conv_stack, name)(*args)
    p = PLAIN[name](*args)
    torch.cuda.synchronize()
    assert conv_stack.LAUNCHES[name] == 1 and conv_stack.TC_LAUNCHES[name] == 0
    assert y.dtype == dtype and y.shape == p.shape
    assert _rel(y.float(), p.float()) < CONV_BUDGETS[dtype]


# (B, C, H, W, O): the net's layers; odd H; short lines of several images
# in one block of 128 ring positions (16- and 32-long lines, O off 64);
# lines of 2 and 3; a block that holds parts of three lines of 47.
RING_SHAPES = [(2, 64, 128, 128, 64), (3, 512, 16, 16, 256), (2, 3, 9, 70, 5),
               (5, 64, 16, 16, 40), (3, 256, 32, 32, 96), (4, 9, 2, 3, 70), (2, 20, 33, 47, 130)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", RING_SHAPES)
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
    ((3, 8, 56, 33), 24), ((2, 8, 24, 16), 8), ((2, 24, 56, 33), 24),
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
        if dtype == torch.bfloat16:  # one tile body, one summation order a pixel
            assert torch.equal(y[:, :, e:-e], fused)
        else:
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


FAST = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints", "fast")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_served_answer_equals_the_direct_call(card, dtype):
    with open(os.path.join(FAST, "config.json")) as f:
        cfg = ExperimentConfig.from_json(f.read())
    net = StyleTransferNet.from_state_dict(load_release_weights(os.path.join(FAST, "torch_weights.npz")),
                                           cfg.model.width)
    style = load_style_vector(os.path.join(FAST, "style_vector.npz"))
    service = RetrievalService(net, style, cfg, batch_size=4, dtype=dtype, device=card)
    holo = load_golden_suite().content_holo[10]  # 5: one batch of 4, one padded
    box, bound = {}, threading.Event()
    t = threading.Thread(target=serve_forever, args=(service, "127.0.0.1", 0), daemon=True,
                         kwargs={"ready": lambda h: (box.setdefault("h", h), bound.set())})
    t.start()
    try:
        assert bound.wait(30)
        asm_cuda.reset_launches()
        got = retrieve_remote(f"http://127.0.0.1:{box['h'].server_address[1]}", holo)
        assert asm_cuda.LAUNCHES["asm_const"] == 2
    finally:
        if "h" in box:
            box["h"].shutdown()
        t.join(30)
    fn = make_retrieval_fn(cfg.physics, dtype=dtype, device=card)
    d_style = float(cfg.physics.to_network_units(cfg.data.style_distances[0]))
    padded = np.concatenate([holo, np.repeat(holo[-1:], 3, axis=0)])
    for lo in (0, 4):
        want = fn(net, padded[lo:lo + 4], *style, d_style)
        n = min(4, len(holo) - lo)
        for k, v in want.items():
            assert np.array_equal(got[k][lo:lo + n], v[:n].cpu().numpy()), k


def test_pinned_prefetch_gives_the_blocking_copies(card):
    g = torch.Generator().manual_seed(0)
    src = [{"holo": torch.rand(8, 1, 128, 128, generator=g).numpy(), "i": np.array([i])}
           for i in range(12)]
    seen = []
    for batch, s in zip(prefetch_to_device(iter(src), device=card), src):
        assert batch["holo"].is_cuda
        want = torch.from_numpy(s["holo"]).to(card)
        # work on the consumer stream between batches, as the stream's net does
        for _ in range(3):
            want = want * 1.0
        assert torch.equal(batch["holo"], want)
        seen.append(int(batch["i"][0]))
    assert seen == list(range(12))


def test_pinned_prefetch_reraises_and_lets_the_producer_go(card):
    def failing():
        yield {"holo": np.zeros((2, 1, 16, 16), np.float32)}
        raise OSError("disk gone")

    it = prefetch_to_device(failing(), device=card)
    assert next(it)["holo"].is_cuda
    with pytest.raises(OSError, match="disk gone"):
        next(it)

    before = threading.active_count()
    endless = ({"holo": np.zeros((2, 1, 16, 16), np.float32)} for _ in iter(int, 1))
    it = prefetch_to_device(endless, device=card)
    next(it)
    it.close()
    deadline = 50
    while threading.active_count() > before and deadline:
        threading.Event().wait(0.1)
        deadline -= 1
    assert threading.active_count() <= before


@pytest.mark.parametrize("shape", [(2, 64, 128, 128, 64), (2, 512, 16, 16, 256), (2, 3, 9, 7, 5)])
def test_border_lines_function_gradient(card, shape):
    b, c, h, w, o = shape
    g = torch.Generator().manual_seed(c + h)
    x = torch.randn(b, c, h, w, generator=g).to(card).requires_grad_()
    k = (torch.randn(o, c, 3, 3, generator=g) / (3 * c ** 0.5)).to(card).requires_grad_()
    up = [torch.randn(b, o, 2, w, generator=g).to(card), torch.randn(b, o, h, 2, generator=g).to(card)]
    before = reflect_border.LAUNCHES["border_lines"]
    got = reflect_border.border_lines(x, k)
    assert reflect_border.LAUNCHES["border_lines"] == before + 1
    want = reflect_border.border_lines_plain(x, k)
    g_got = torch.autograd.grad(sum((t * u).sum() for t, u in zip(got, up)), (x, k))
    g_want = torch.autograd.grad(sum((t * u).sum() for t, u in zip(want, up)), (x, k))
    torch.cuda.synchronize()
    for a, e in zip(got + g_got, want + g_want):
        assert _rel(a, e) < CONV_BUDGETS[torch.float32]
    with torch.no_grad():
        rows, _ = reflect_border.border_lines(x, k)
    assert rows.grad_fn is None


def _step_gradients(cfg, params, disc_params, batch, device, dtype=torch.float32):
    """One step's gradients (float64, on the CPU): the generator's under
    "params", the discriminator's LSGAN loss on the style holograms and the
    detached ``g_t`` under "disc_params"; net and discriminator in
    ``dtype``, the distance head in fp32."""
    from torch.func import functional_call

    from style_transfer_based_holographic_imaging_tpu_torch.train import generator_loss_fn, lsgan_d_loss

    net = StyleTransferNet(width=cfg.model.width).to(device, dtype)
    net.distance_g.float()
    disc = PatchDiscriminator(image_size=cfg.data.image_size).to(device, dtype)
    p = {k: (v.float() if k.startswith("distance_g.") else v.to(dtype)).to(device).requires_grad_()
         for k, v in params.items()}
    b = {k: v.to(device, dtype) for k, v in batch.items()}
    dp = {k: v.to(device, dtype) for k, v in disc_params.items()}
    loss, aux = generator_loss_fn(p, b, net=net, physics=cfg.physics, cfg=cfg.train, disc=disc,
                                  disc_params=dp)
    grads = torch.autograd.grad(loss, list(p.values()))
    dp = {k: v.requires_grad_() for k, v in dp.items()}
    real, _ = functional_call(disc, dp, (b["style_holo"],))
    fake, _ = functional_call(disc, dp, (aux["g_t"].detach(),))
    dgrads = torch.autograd.grad(lsgan_d_loss(real, fake), list(dp.values()), allow_unused=True)
    host = lambda g, like: (torch.zeros_like(like) if g is None else g).detach().double().cpu()  # noqa: E731
    return {"params": {k: host(g, p[k]) for k, g in zip(p, grads)},
            "disc_params": {k: host(g, dp[k]) for k, g in zip(dp, dgrads)}}


def test_one_train_step_card_against_cpu(card):
    from style_transfer_based_holographic_imaging_tpu_torch.data import synth

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "checkpoints", "config.json")) as f:
        cfg = ExperimentConfig.from_json(f.read())
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, width=0.25),
                              data=dataclasses.replace(cfg.data, batch_size=2, image_size=64, digit_pad=16))
    bank = torch.from_numpy(synth.golden_digit_bank(load_golden_suite(), size=32,
                                                    subset=synth.GOLDEN_TRAIN_DIGITS))
    batch = synth.synth_batch(0, bank, cfg.data, cfg.physics, return_gt=True)
    params = init_net_params(torch.Generator().manual_seed(0), width=0.25)
    disc_params = init_params(PatchDiscriminator(image_size=64), torch.Generator().manual_seed(1))
    out, grads = {}, {}
    for dev in ("cpu", card):
        state = create_train_state(params, cfg.train, disc_params=disc_params, device=dev)
        step = TrainStep(StyleTransferNet(width=0.25).to(dev), cfg.physics, cfg.train,
                         disc=PatchDiscriminator(image_size=64).to(dev))
        state, aux = step(state, {k: v.to(dev) for k, v in batch.items()})
        out[str(dev)] = state, {k: float(v) for k, v in aux.items()}
        grads[str(dev)] = _step_gradients(cfg, params, disc_params, batch, dev)
    anchor = _step_gradients(cfg, params, disc_params, batch, card, torch.float64)
    (cpu, cpu_aux), (gpu, gpu_aux) = out["cpu"], out[str(card)]
    for k in cpu_aux:
        assert abs(gpu_aux[k] - cpu_aux[k]) < 1e-4 * abs(cpu_aux[k]), k
    for dev, got in grads.items():
        for group, want in anchor.items():
            for k, w in want.items():
                assert float((got[group][k] - w).abs().max()) <= 2e-3 * float(w.abs().max()), (dev, k)
    lr, eps = cfg.train.lr, 1e-8
    clip = min(1.0, cfg.train.grad_clip_norm / math.sqrt(sum(float((g * g).sum())
                                                              for g in anchor["params"].values())))
    for group in ("params", "ema_params", "disc_params"):
        a, e = getattr(gpu, group), getattr(cpu, group)
        grad_group = "disc_params" if group == "disc_params" else "params"
        c = clip if grad_group == "params" else 1.0
        scale = 1.0 - cfg.train.ema_decay if group == "ema_params" else 1.0
        for k in e:
            w = anchor[grad_group][k]
            noise = c * max(float((g[grad_group][k] - w).abs().max()) for g in grads.values())
            hi, lo = c * w.abs() + noise, c * w.abs() - noise
            spread = torch.where(lo > 0, lr * eps * (hi - lo) / ((hi + eps) * (lo + eps)),
                                 torch.full_like(w, 2 * lr))
            spread = scale * torch.where(w == 0, torch.zeros_like(w), spread)
            diff = (a[k].cpu().double() - e[k].double()).abs()
            assert bool((diff <= 1e-4 * float(e[k].abs().max()) + spread).all()), (group, k)


# --------------------------------------------------------------------------
# The kernels as custom ops, and the frozen artifact on the card
# --------------------------------------------------------------------------


def _op_cases(card):
    """Each ``holostyle::`` op's arguments at small shapes on the card, fp32;
    the ASM planes and the ring's inputs with gradients."""
    g = torch.Generator().manual_seed(7)
    xre, xim = (t.requires_grad_() for t in _planes(2, 16, 16, card, seed=7))
    dist = torch.tensor([1e-4, -2e-4], device=card, requires_grad=True)
    x = torch.randn(2, 4, 9, 12, generator=g).to(card).requires_grad_()
    k = torch.randn(6, 4, 3, 3, generator=g).to(card).requires_grad_()
    wl, px = KW["wavelength"], KW["pixel_size"]
    tail = _stack_args(card, torch.float32, 8, (8, 8, 2), b=2, h=24, w=16)
    return {
        "asm_const": (xre, xim, -2e-4, wl, px, "high"),
        "asm_dynamic": (xre, xim, dist, wl, px, "high"),
        "border_lines": (x, k),
        "fused_encoder_head": tuple(_stack_args(card, torch.float32, 1, (8, 8), b=2, h=16, w=20)),
        "fused_conv_tail": tuple(tail),
        "halo_interior": (*tail, 8),
        "halo_interior_static": (*tail, 8),
    }


@pytest.mark.parametrize("name", ["asm_const", "asm_dynamic", "border_lines", "fused_encoder_head",
                                  "fused_conv_tail", "halo_interior", "halo_interior_static"])
def test_ops_pass_opcheck_on_the_card(card, name):
    torch.library.opcheck(getattr(torch.ops.holostyle, name).default, _op_cases(card)[name])


@pytest.mark.parametrize("path", ["fp32", "int8"])
def test_artifact_with_the_kernels_equals_the_live_path(card, tmp_path, path):
    """fp32: the refocus as ``asm_const``; int8 with the stacks on: the head
    and tail ops too, the tail's input channels-last at run time (cuDNN's
    transposed conv of a channels-last input) where the trace saw it
    contiguous."""
    from style_transfer_based_holographic_imaging_tpu_torch.kernels import library
    from style_transfer_based_holographic_imaging_tpu_torch.models import quant
    from style_transfer_based_holographic_imaging_tpu_torch.pipelines.export_artifact import (
        export_retrieval,
        load_artifact,
        save_artifact,
    )

    cfg = ExperimentConfig()
    net = StyleTransferNet(width=0.25)
    net.load_state_dict(init_net_params(torch.Generator().manual_seed(0), width=0.25))
    rng = np.random.default_rng(0)
    c = net.encoder.out_channels
    style = (rng.random((1, 1, 1, c), np.float32), (0.5 + rng.random((1, 1, 1, c))).astype(np.float32))
    holo = rng.random((3, 1, 128, 128), np.float32)
    kw, ops = {}, ["holostyle.asm_const.default"]
    if path == "int8":
        kw["quant_scales"] = quant.calibrate_scales(net, [np.sqrt(holo)], *style, device="cpu")
        ops = ops + ["holostyle.fused_conv_tail.default", "holostyle.fused_encoder_head.default"]
    file = str(tmp_path / "a.hstx")
    quant.set_fused_stacks("on")
    try:
        save_artifact(file, *export_retrieval(net, style, cfg, batch_size=2, asm_backend="cuda", **kw))
        art = load_artifact(file)
        assert sorted(set(library.graph_ops(art._module.graph))) == ops
        asm_cuda.reset_launches()
        got = art.retrieve(holo)
        assert asm_cuda.LAUNCHES == {"asm_const": 2, "asm_dynamic": 0}
        fn = make_retrieval_fn(cfg.physics, device=card, **kw)
        d = float(cfg.physics.to_network_units(cfg.data.style_distances[0]))
        net = net.to(card)
        padded = np.concatenate([holo, holo[-1:]])
        for lo in (0, 2):
            want = fn(net, padded[lo:lo + 2], *style, d)
            n = min(2, len(holo) - lo)
            for key, v in want.items():
                assert np.array_equal(got[key][lo:lo + n], v[:n].cpu().numpy()), key
    finally:
        quant.set_fused_stacks("auto")
