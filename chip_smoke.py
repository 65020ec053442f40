#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card, and check it.

    python3 chip_smoke.py

Phases, each under its own wall-clock budget (a phase that overruns prints a
line naming it and ends the run with exit code 3; nothing hangs):

1. ``device``  — a CUDA card must be present (else exit 2); prints the card's
   name and power limit (``nvidia-smi``) and the TF32 flags.
2. ``build``   — removes stale build files, compiles the four kernel sources
   with one ``nvcc`` each, all started together, loads the libraries with
   ``ctypes``; prints each source's ``nvcc`` seconds and the ``-Xptxas -v``
   lines (registers, shared memory, spills) of every source.
3. ``kernels`` — each kernel against its plain PyTorch version. The ASM
   kernels also against the ``torch.fft`` composition, at B = 5 and 256, in
   every precision mode, with per-sample distances spread over the suite's
   range for ``asm_dynamic``, and against the plain version alone at the
   ragged shapes ``ODD_SHAPES``; tolerance on max|err| / max|ref|: 1e-5
   (highest), 1e-4 (high), 2e-2 (bf16), the JAX package's budgets. The conv
   stacks at flagship shapes and the border ring at ``RING_LAYERS`` (three
   of the net's layers, one odd H, short lines that share a block, output
   channels off 64), at B = 5 and 256, in fp32 and bf16, the tail at the
   ragged shapes ``TAIL_ODD_SHAPES``, the head at ``HEAD_ODD_SHAPES`` (the
   releases' widths, H and W off its tile), both also at 80 channels, past
   the tensor-core bodies' 64 (bf16 there runs the SIMT body); tolerance
   1e-5 in fp32
   (summation order) and 1e-2 in bf16 (a value that the other summation
   order puts on a bf16 rounding boundary rounds the other way, 2^-8
   relative, and carries into the next layer).
4. ``slice``   — the flagship-width net (width 1.0) on weights drawn from
   ``torch.Generator`` seed 0: the whole 20 x 5 golden suite through
   ``evaluate_golden_suite`` and one ``retrieval_step`` with per-sample style
   distances, with the launch counts reset just before and read just after;
   both ASM kernels must have launched. Then one golden batch on the card
   against the same port on the CPU.
5. ``refine``  — physics refinement, whose steps differentiate the
   propagator: the gradients of ``asm_cuda.AsmConst`` and ``AsmDynamic``
   (the kernels forward, the composition's adjoint in ``torch.fft``
   backward) against
   ``propagate_torch`` autograd at B = 5 and 256, in ``high`` and
   ``highest``, rtol 1e-3 of the largest gradient; ``physics_refine`` on
   golden batch 10 from its GT phase plus 0.3 rad of noise (numpy seed 0) at
   the true distances, 100 steps, on the card against the same call on the
   CPU (PSNR within 0.05 dB); ``evaluate_golden_suite(refine_steps=100)`` on
   the seeded net with the launch counts reset just before and read just
   after (``asm_dynamic`` must have launched 20 x 101 times); one refine at
   B = 256, 128^2, 100 steps timed with CUDA events, beside the same refine
   through ``torch.fft`` alone (``asm_backend='torch'``), and split into the
   forward kernel, the adjoint backward and the rest.
6. ``quant``   — the int8 serving path on the same net: int8 scales
   calibrated on the golden suite, then the suite through
   ``evaluate_golden_suite(quant_scales=..., dtype=bf16)`` with the fused
   stacks on, the counts reset just before and read just after (both stack
   kernels must have launched, every launch on the tensor cores). Then one
   golden batch against the same
   port on the CPU: every int8 conv, stack and transposed conv of the
   card's run again on the CPU from the same inputs, where the two runs
   part (differing int8 steps, call by call), what one int8 step moves, the
   outputs, and the same path without int8 convs. Last, the suite once more
   with the stacks off.
7. ``reflect`` — ``retrieval_step`` on one golden batch with the reflect
   backend ``cuda`` (the border ring must launch once for each of the net's
   20 reflect convs, whose shapes the phase records), against the
   ``matpad`` backend on the card.
8. ``halo``    — the halo row-block decoder tail, the path of
   ``scripts/port_exp_halo_conv.py``: ``halo_conv_tail`` and
   ``halo_conv_tail_static`` at B = 256, 128^2 x 64 -> 2, bf16, bh 30 and
   60, with the halo counts reset just before and read just after (both
   kernels must have launched). Then both kernels against
   ``halo_conv_tail_plain`` at B = 5 and 256, fp32 and bf16, bh 30 and 60,
   C = 64 (flagship) and 16 (``ultra``'s width), and at the ragged shapes
   ``HALO_ODD_SHAPES``, and their interior rows against ``fused_conv_tail``
   on the same input (the same function there, the same tile body): equal
   bit for bit in bf16, within the conv tolerance in fp32. Then both
   kernels and ``conv_tail_reference`` on the card against the port's CPU
   versions on the same inputs (the edge rows' strips take cuDNN's convs on
   the card), bf16 edge rows within four ulps of max|ref|. Times at B = 256
   of the script's rows.
9. ``timing``  — CUDA-event medians at B = 256 of each kernel, its plain
   version and its library call in fp32 and bf16, the ring at each of the
   20 reflect convs of the step (and their sum beside its bound), and of
   the whole
   ``retrieval_step`` (holograms/s): fp32, int8 with the stacks on and with
   them off (with the stages of each), fp32 with the ring.

Then the ``nvidia-smi`` line, one JSON line listing every kernel, and the
final JSON line ``{"ok": true, "device": {...}}``. Any failure exits
non-zero before that line. The script imports the port (and the port's
``scripts/port_exp_halo_conv.py``), torch, numpy and the standard library
only.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import math
import os
import subprocess
import sys
import threading
import time

_t_start = time.monotonic()
REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from style_transfer_based_holographic_imaging_tpu_torch import ExperimentConfig  # noqa: E402
from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite  # noqa: E402
from style_transfer_based_holographic_imaging_tpu_torch.eval import psnr, zero_mean  # noqa: E402

from style_transfer_based_holographic_imaging_tpu_torch.kernels import (  # noqa: E402
    _build,
    asm_cuda,
    conv_stack,
    halo_conv,
    reflect_border,
)
from style_transfer_based_holographic_imaging_tpu_torch.models import (  # noqa: E402
    ConvTranspose2x2,
    StyleTransferNet,
    set_reflect_backend,
    split_style_vector,
)
from style_transfer_based_holographic_imaging_tpu_torch.models import quant  # noqa: E402
from style_transfer_based_holographic_imaging_tpu_torch.ops import holo_forward, unwrap_phase  # noqa: E402
from style_transfer_based_holographic_imaging_tpu_torch.ops.asm import propagate_torch  # noqa: E402
from style_transfer_based_holographic_imaging_tpu_torch.ops.stats import (  # noqa: E402
    adain_with_stats,
    calc_mean_std,
)
from style_transfer_based_holographic_imaging_tpu_torch.pipelines import (  # noqa: E402
    evaluate_golden_suite,
    physics_refine,
    retrieval_step,
)
from style_transfer_based_holographic_imaging_tpu_torch.utils.bench import (  # noqa: E402
    head_library,
    median_ms,
    recording_ring_layers,
    seeded_stack,
    time_ring_layers,
)


def _load_script(name: str):
    path = os.path.join(REPO, "scripts", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# The halo tail's experiment: its rows are the halo phase's timed rows.
halo_exp = _load_script("port_exp_halo_conv")

TOTAL_BUDGET_S = 285.0
BUDGETS_S = {
    "device": 60.0, "build": 150.0, "kernels": 90.0, "slice": 90.0, "refine": 60.0,
    "quant": 90.0, "reflect": 60.0, "halo": 60.0, "timing": 120.0,
}
TOLERANCES = {"highest": 1e-5, "high": 1e-4, "bf16": 2e-2}
# (B, H, W) where the ASM kernels' tensor-core tiles are ragged: the card
# tests' (1, 16, 16) and (2, 48, 64); (2, 48, 80); (2, 40, 56), whose M, N
# and K are off a multiple of 64 in all four stages; (2, 18, 30), whose
# operand rows are padded to 8 elements.
ODD_SHAPES = ((1, 16, 16), (2, 48, 64), (2, 48, 80), (2, 40, 56), (2, 18, 30))
# Card tolerances for the same golden batch on the card (cuDNN fp32 convs,
# the "high" DFT kernel) against the CPU (fp32 convs, the torch.fft path):
# max|err| / max|ref| of amp_foc, |err| of distance_pred (in (0, 1)), and the
# phase compared modulo 2 pi (the congruence snap may move a pixel at a tie
# by a whole 2 pi) in at least PHASE_FRACTION of the pixels.
SLICE_AMP_TOL = 1e-3
SLICE_DIST_TOL = 1e-4
SLICE_PHASE_TOL = 1e-2
SLICE_PHASE_FRACTION = 0.999
# The conv kernels against their plain versions, by dtype (see the docstring).
CONV_TOLERANCES = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# The int8 path on the card against the same port on the CPU, one golden
# batch, in fp32 and in bf16 compute. Every call of these ops in the card's
# run is recomputed on the CPU from the same inputs: the int8 convs must
# agree bit for bit (the int32 sums are exact, the rest single IEEE
# operations on both), the stacks and the transposed convs within
# CONV_TOLERANCES. The two runs' own inputs part where the fp parts sum in
# other orders and an activation crosses a rounding tie: it requantizes to
# the neighbouring int8 step. The run counts those steps call by call, and
# measures what one step in the first int8 conv's input moves at the
# output (``one_int8_step``). On the seeded net, golden batch 10, that one
# step moves amp_foc by 14.5 % (fp32) and 12.5 % (bf16) of max|ref|, 5.8 %
# and 5.7 % in L2 norm (NVIDIA H100 80GB HBM3, 700 W; this script). The
# whole path's outputs are held to QUANT_PATH_TOL, about 2.5 times those
# readings; the path with no int8 conv (empty scales: the stacks, cuDNN and
# the transposed convs in fp32, nothing to requantize) is held to the
# slice's tolerances.
QUANT_OPS = ("int8_conv_valid", "fused_encoder_head", "fused_conv_tail", "_conv_fp")
QUANT_PATH_TOL = {
    torch.float32: {"amp_foc_rel_err": 0.35, "amp_foc_rel_l2": 0.15, "distance_pred_abs_err": 1e-3},
    torch.bfloat16: {"amp_foc_rel_err": 0.35, "amp_foc_rel_l2": 0.15, "distance_pred_abs_err": 0.05},
}
# The net's reflect convs: 9 in the encoder, 11 in the decoder.
REFLECT_CONVS = 20
# Layers of the border ring's checks: (C, H, W, O) of three of the net's
# reflect convs, one odd H, and short lines that share a block of 128 ring
# positions with output channels off a multiple of 64; the first is timed.
RING_LAYERS = ((64, 128, 128, 64), (3, 128, 128, 64), (64, 64, 64, 128), (512, 16, 16, 256),
               (64, 127, 128, 64), (64, 16, 16, 40), (256, 32, 32, 96))
# Physics refinement: the Functions' gradients against propagate_torch
# autograd, max|err| / max|ref| (the JAX package's gradient budget, rtol
# 1e-3); the refine of golden batch 10 from its GT phase plus REFINE_NOISE_RAD
# of noise, on the card against the CPU, PSNR within REFINE_DB_TOL.
GRAD_TOL = 1e-3
REFINE_STEPS = 100
REFINE_BATCH = 10
REFINE_NOISE_RAD = 0.3
REFINE_DB_TOL = 0.05
REFINE_PAIRS = 10  # timed refines through each backend at B_TIMING
B_TIMING = 256
IMAGE = 128
SERVING_REFOCUS_M = -2e-4  # -d_style = -0.2 mm, the golden suite's style plane
# Peaks by card (NVIDIA data sheets, dense): fp32 FLOP/s outside the tensor
# cores, bf16 FLOP/s on the tensor cores, bytes/s.
PEAKS = {
    "H100 PCIe": (51.2e12, 756e12, 2.0e12),
    "H100 NVL": (60.0e12, 835e12, 3.9e12),
    "H100": (67.0e12, 989e12, 3.35e12),
}
# Real products per product of the DFT, and the rate's type, by precision
# mode: `highest` multiplies fp32 operands; `high` does each product as three
# products of bf16-rounded operands with fp32 accumulation (hi*hi + hi*lo +
# lo*hi), `bf16` as one, which the card's tensor cores run at the bf16 rate.
PRODUCTS = {"highest": (1, "fp32"), "high": (3, "bf16"), "bf16": (1, "bf16")}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _die(message: str, code: int) -> None:
    print(message, file=sys.stderr, flush=True)
    emit({"error": message})
    _build.kill_build()
    os._exit(code)


class Phase:
    """A phase under a wall-clock budget: overrunning it, or the whole run's,
    ends the process with exit code 3 and a line naming the phase."""

    def __init__(self, name: str):
        self.name = name
        self.info: dict = {}

    def __enter__(self):
        left = TOTAL_BUDGET_S - (time.monotonic() - _t_start)
        budget = min(BUDGETS_S[self.name], left)
        self._timer = threading.Timer(
            max(budget, 0.0),
            _die,
            args=(f"phase {self.name!r} overran its budget of {budget:.0f} s", 3),
        )
        self._timer.daemon = True
        self._timer.start()
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._timer.cancel()
        if exc_type is not None:
            return False
        emit({"phase": self.name, "seconds": round(time.monotonic() - self._t0, 3), **self.info})
        return False


def _dt(dtype) -> str:
    return str(dtype).replace("torch.", "")


def rel_err(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


def bf16_ulp(ref) -> float:
    """bf16's spacing at max|ref|, 2^(floor(log2 max|ref|) - 7)."""
    return 2.0 ** (math.floor(math.log2(float(ref.abs().max()))) - 7)


def random_planes(b: int, seed: int, device):
    g = torch.Generator().manual_seed(seed)
    xre = torch.rand(b, IMAGE, IMAGE, generator=g).to(device)
    xim = torch.rand(b, IMAGE, IMAGE, generator=g).to(device)
    return xre, xim


def spread_distances(b: int, device):
    """Per-sample refocus distances over the suite's range, both signs (m)."""
    return torch.linspace(-0.8e-3, 0.8e-3, b, dtype=torch.float32).to(device)


@torch.no_grad()
def seeded_weights_(net: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Fill every weight from ``torch.Generator`` seed ``seed``: He-normal
    kernels (std sqrt(2 / fan_in), so activations keep their scale through
    the ReLU stack) and N(0, 0.01^2) biases. The release's own weights are
    orbax files that this machine cannot read."""
    g = torch.Generator().manual_seed(seed)
    for module in net.modules():
        if not isinstance(module, (torch.nn.Conv2d, torch.nn.Linear, ConvTranspose2x2)):
            continue
        w = module.weight
        # a transposed conv's output sums C_in taps; the others sum a row of w
        fan_in = w.shape[0] if isinstance(module, ConvTranspose2x2) else w[0].numel()
        w.copy_(torch.randn(w.shape, generator=g) * (2.0 / fan_in) ** 0.5)
        module.bias.copy_(0.01 * torch.randn(module.bias.shape, generator=g))
    return net


def phase_device():
    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the port on a card", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip().splitlines()[0]
    return smi


def check_odd_shapes(kw, device):
    """Both ASM kernels against their plain versions at ODD_SHAPES, in every
    precision mode (the tensor-core tiles' ragged edges)."""
    rows = []
    for b, h, w in ODD_SHAPES:
        g = torch.Generator().manual_seed(h + w)
        xre = torch.rand(b, h, w, generator=g).to(device)
        xim = torch.rand(b, h, w, generator=g).to(device)
        dist = spread_distances(b, device)
        for prec, tol in TOLERANCES.items():
            for name, run, plain, d in (
                ("asm_const", asm_cuda.asm_const, asm_cuda.asm_const_plain, SERVING_REFOCUS_M),
                ("asm_dynamic", asm_cuda.asm_dynamic, asm_cuda.asm_dynamic_plain, dist),
            ):
                y = torch.complex(*run(xre, xim, d, precision=prec, **kw))
                p = torch.complex(*plain(xre, xim, d, precision=prec, **kw))
                torch.cuda.synchronize()
                row = {"kernel": name, "shape": [b, h, w], "precision": prec, "tol": tol,
                       "max_abs_err": float((y - p).abs().max()), "rel_err_vs_plain": rel_err(y, p)}
                rows.append(row)
                if not row["rel_err_vs_plain"] < tol:
                    _die(f"kernel check failed: {json.dumps(row)}", 1)
    return rows


def check_kernels(physics, device, batches=(5, 256)):
    """Each kernel against its plain version and the torch.fft composition,
    at B = 5 and 256 on 128^2, then at ODD_SHAPES against the plain version."""
    kw = dict(wavelength=physics.wavelength, pixel_size=physics.pixel_size)
    rows = check_odd_shapes(kw, device)
    for b in batches:
        xre, xim = random_planes(b, seed=b, device=device)
        field = torch.complex(xre, xim)
        dist = spread_distances(b, device)
        fft_const = propagate_torch(field, SERVING_REFOCUS_M, **kw)
        fft_dyn = propagate_torch(field, dist.reshape(b, 1, 1), **kw)
        for prec, tol in TOLERANCES.items():
            for name, run, run_plain, fft in (
                ("asm_const",
                 lambda: asm_cuda.asm_const(xre, xim, SERVING_REFOCUS_M, precision=prec, **kw),
                 lambda: asm_cuda.asm_const_plain(xre, xim, SERVING_REFOCUS_M, precision=prec, **kw),
                 fft_const),
                ("asm_dynamic",
                 lambda: asm_cuda.asm_dynamic(xre, xim, dist, precision=prec, **kw),
                 lambda: asm_cuda.asm_dynamic_plain(xre, xim, dist, precision=prec, **kw),
                 fft_dyn),
            ):
                y = torch.complex(*run())
                p = torch.complex(*run_plain())
                torch.cuda.synchronize()
                row = {
                    "kernel": name, "B": b, "shape": [b, IMAGE, IMAGE], "precision": prec, "tol": tol,
                    "max_abs_err": float((y - p).abs().max()),
                    "rel_err_vs_plain": rel_err(y, p),
                    "rel_err_vs_fft": rel_err(y, fft),
                }
                rows.append(row)
                if not (row["rel_err_vs_plain"] < tol and row["rel_err_vs_fft"] < tol):
                    _die(f"kernel check failed: {json.dumps(row)}", 1)
    return rows


def drive_slice(net, goldens, cfg, device):
    """The main path: the whole golden suite, then one batch with per-sample
    style distances. Returns (metrics, per-sample output)."""
    metrics = evaluate_golden_suite(net, goldens, cfg, device=device)
    d_style = goldens.distance_style[0] * (1.0 + 0.05 * np.arange(goldens.batch_size)).reshape(-1, 1, 1, 1)
    out = retrieval_step(
        net, goldens.content_holo[0], goldens.style_mean, goldens.style_std,
        d_style.astype(np.float32), cfg.physics, device=device,
    )
    return metrics, out


def check_slice_outputs(metrics, out, b: int):
    for key in ("mean_psnr", "mean_mae", "r2", "heldout_mean_psnr"):
        if not math.isfinite(metrics[key]):
            _die(f"slice metric {key} is not finite: {metrics[key]}", 1)
    if len(metrics["psnr_per_batch"]) != 20 or len(metrics["distance_pred_um"]) != 100:
        _die("slice metrics do not cover the 20 x 5 suite", 1)
    shapes = {"amp_field": (b, 1, IMAGE, IMAGE), "ph_field": (b, 1, IMAGE, IMAGE),
              "amp_foc": (b, 1, IMAGE, IMAGE), "ph_foc": (b, 1, IMAGE, IMAGE),
              "distance_pred": (b, 1, 1, 1)}
    for key, shape in shapes.items():
        t = out[key]
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            _die(f"slice output {key}: shape {tuple(t.shape)} (want {shape}) or non-finite", 1)


def compare_card_cpu(net, goldens, cfg, batch: int):
    """One golden batch on the card against the same port on the CPU."""
    net_cpu = copy.deepcopy(net).cpu()
    args = (goldens.content_holo[batch], goldens.style_mean, goldens.style_std,
            float(goldens.distance_style[batch].reshape(-1)[0]), cfg.physics)
    gpu = retrieval_step(net, *args, device="cuda")
    cpu = retrieval_step(net_cpu, *args, device="cpu")
    return {"batch": batch, **compare_outputs(
        gpu, cpu, SLICE_AMP_TOL, SLICE_DIST_TOL, SLICE_PHASE_TOL, SLICE_PHASE_FRACTION,
        "card and CPU on the slice")}


def _grads_of(fn, xre, xim, dist, weights):
    """Gradients of a real loss, nonlinear in (yre, yim), for xre, xim and
    a tensor ``dist``."""
    inputs = [xre.clone().requires_grad_(), xim.clone().requires_grad_()]
    if isinstance(dist, torch.Tensor):
        inputs.append(dist.clone().requires_grad_())
    yre, yim = fn(*inputs)
    loss = (weights[0] * yre + weights[1] * yim * yim + 0.3 * (yre * yre + yim * yim) ** 2).sum()
    return torch.autograd.grad(loss, inputs)


def check_function_grads(physics, device, batches=(5, 256)):
    """AsmConst's field gradient and AsmDynamic's field and distance
    gradients against propagate_torch autograd on the card."""
    kw = dict(wavelength=physics.wavelength, pixel_size=physics.pixel_size)
    rows = []
    for b in batches:
        xre, xim = random_planes(b, seed=b + 1, device=device)
        g = torch.Generator().manual_seed(b + 2)
        weights = torch.randn(2, b, IMAGE, IMAGE, generator=g).to(device)
        dist = spread_distances(b, device)

        def fft(xre, xim, d=SERVING_REFOCUS_M):
            y = propagate_torch(torch.complex(xre, xim), d.reshape(-1, 1, 1) if isinstance(
                d, torch.Tensor) else d, **kw)
            return y.real, y.imag

        for prec in ("high", "highest"):
            for name, fn, d in (
                ("asm_const", lambda xr, xi, p=prec: asm_cuda.AsmConst.apply(
                    xr, xi, SERVING_REFOCUS_M, kw["wavelength"], kw["pixel_size"], p), None),
                ("asm_dynamic", lambda xr, xi, dd, p=prec: asm_cuda.AsmDynamic.apply(
                    xr, xi, dd, kw["wavelength"], kw["pixel_size"], p), dist),
            ):
                got = _grads_of(fn, xre, xim, d, weights)
                ref = _grads_of(fft, xre, xim, d, weights)
                torch.cuda.synchronize()
                errs = [rel_err(a, r) for a, r in zip(got, ref)]
                row = {"function": name, "B": b, "precision": prec, "tol": GRAD_TOL,
                       "rel_err_field": max(errs[:2]),
                       "rel_err_distance": errs[2] if len(errs) > 2 else None}
                rows.append(row)
                if not max(errs) < GRAD_TOL or not all(float(r.abs().max()) > 0 for r in ref):
                    _die(f"gradient check failed: {json.dumps(row)}", 1)
    return rows


def noisy_golden_batch(goldens, b=None, seed=0):
    """Golden batch REFINE_BATCH's (amplitude, GT phase plus REFINE_NOISE_RAD
    of numpy-seeded noise, true distances, sqrt hologram, GT phase); with
    ``b``, the whole suite's samples tiled to b images instead."""
    if b is None:
        gt, d, holo = (goldens.gt_phase[REFINE_BATCH], goldens.distance_content[REFINE_BATCH],
                       goldens.content_holo[REFINE_BATCH])
    else:
        idx = np.arange(b) % (goldens.n_batches * goldens.batch_size)
        gt = goldens.gt_phase.reshape(-1, 1, IMAGE, IMAGE)[idx]
        d = goldens.distance_content.reshape(-1, 1, 1, 1)[idx]
        holo = goldens.content_holo.reshape(-1, 1, IMAGE, IMAGE)[idx]
    rng = np.random.default_rng(seed)
    ph0 = (gt + REFINE_NOISE_RAD * rng.standard_normal(gt.shape)).astype(np.float32)
    return np.full_like(gt, 0.6), ph0, d, np.sqrt(holo), gt


def refined_psnr(out, gt) -> float:
    return float(psnr(zero_mean(out["phase"].cpu()), zero_mean(torch.as_tensor(gt))))


def refine_card_vs_cpu(goldens, physics, device):
    """The physics-anchored refine on the card and on the CPU; the card's
    asm_dynamic launches of its run."""
    amp, ph0, d, meas, gt = noisy_golden_batch(goldens)
    kw = dict(steps=REFINE_STEPS, optimize_amp=False)
    asm_cuda.reset_launches()
    card = physics_refine(amp, ph0, d, meas, physics, device=device, **kw)
    torch.cuda.synchronize()
    launches = asm_cuda.LAUNCHES["asm_dynamic"]
    cpu = physics_refine(amp, ph0, d, meas, physics, device="cpu", **kw)
    row = {"batch": REFINE_BATCH, "steps": REFINE_STEPS, "noise_rad": REFINE_NOISE_RAD,
           "card_psnr_db": refined_psnr(card, gt), "cpu_psnr_db": refined_psnr(cpu, gt),
           "start_psnr_db": refined_psnr({"phase": torch.as_tensor(ph0)}, gt),
           "card_residual_mean": float(card["residual"].mean()),
           "cpu_residual_mean": float(cpu["residual"].mean()),
           "asm_dynamic_launches": launches, "tol_db": REFINE_DB_TOL}
    if not abs(row["card_psnr_db"] - row["cpu_psnr_db"]) < REFINE_DB_TOL or launches != REFINE_STEPS + 1:
        _die(f"refine on the card and the CPU part: {json.dumps(row)}", 1)
    return row


def _timed_refine(amp, ph0, d, meas, physics, backend, kw) -> float:
    """ms of one physics_refine by CUDA events, the launch counts reset
    just before it."""
    asm_cuda.reset_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    physics_refine(amp, ph0, d, meas, physics, asm_backend=backend, **kw)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def time_refine(goldens, physics, device, b: int = B_TIMING):
    """One refine of b images at 128^2, REFINE_STEPS steps, its wall time by
    CUDA events, through the kernels (``auto``) and through torch.fft alone
    (``torch``): REFINE_PAIRS pairs, which path runs first alternating, each
    path's median and quartiles, and the pairs the kernel path won; then at
    the same shapes the forward kernel (asm_dynamic) and the Function's
    backward (the adjoint) alone, and torch autograd's backward of
    ``propagate_torch``, each a median of CUDA-event times; the rest of a
    step is what neither takes."""
    amp, ph0, d, meas, _ = (torch.as_tensor(a, device=device) for a in noisy_golden_batch(goldens, b))
    kw = dict(steps=REFINE_STEPS, optimize_amp=False, device=device)
    runs = {"auto": [], "torch": []}
    launches = {}
    for backend in ("auto", "torch"):  # warm-up
        physics_refine(amp, ph0, d, meas, physics, asm_backend=backend, **dict(kw, steps=2))
    for i in range(REFINE_PAIRS):
        order = ("auto", "torch") if i % 2 == 0 else ("torch", "auto")
        for backend in order:
            runs[backend].append(_timed_refine(amp, ph0, d, meas, physics, backend, kw))
            launches.setdefault(backend, set()).add(asm_cuda.LAUNCHES["asm_dynamic"])
    if launches != {"auto": {REFINE_STEPS + 1}, "torch": {0}}:
        _die(f"timed refines launched asm_dynamic {launches} times, want "
             f"{{'auto': {REFINE_STEPS + 1}, 'torch': 0}} a run", 1)
    total_ms = float(np.median(runs["auto"]))
    torch_total_ms = float(np.median(runs["torch"]))
    wins = sum(a < t for a, t in zip(runs["auto"], runs["torch"]))

    xre = (amp * torch.cos(ph0)).reshape(b, IMAGE, IMAGE).contiguous()
    xim = (amp * torch.sin(ph0)).reshape(b, IMAGE, IMAGE).contiguous()
    dist = physics.to_metres(d).reshape(b).contiguous()
    okw = dict(wavelength=physics.wavelength, pixel_size=physics.pixel_size)
    fwd_ms = median_ms(lambda: asm_cuda.asm_dynamic(xre, xim, dist, **okw))
    xr, xi = xre.clone().requires_grad_(), xim.clone().requires_grad_()
    yre, yim = asm_cuda.AsmDynamic.apply(xr, xi, dist, okw["wavelength"], okw["pixel_size"], None)
    gre, gim = torch.randn_like(yre), torch.randn_like(yim)
    bwd_ms = median_ms(lambda: torch.autograd.grad((yre, yim), (xr, xi), (gre, gim), retain_graph=True))
    y = propagate_torch(torch.complex(xr, xi), dist.reshape(b, 1, 1), **okw)
    torch_bwd_ms = median_ms(
        lambda: torch.autograd.grad((y.real, y.imag), (xr, xi), (gre, gim), retain_graph=True))
    step_ms = total_ms / REFINE_STEPS
    fwd_step = fwd_ms * (REFINE_STEPS + 1) / REFINE_STEPS
    return {
        "B": b, "steps": REFINE_STEPS, "asm_dynamic_launches": REFINE_STEPS + 1, "pairs": REFINE_PAIRS,
        "total_ms": total_ms, "total_ms_quartiles": np.percentile(runs["auto"], [25, 75]).tolist(),
        "total_ms_runs": runs["auto"], "step_ms": step_ms,
        "torch_backend_total_ms": torch_total_ms,
        "torch_backend_total_ms_quartiles": np.percentile(runs["torch"], [25, 75]).tolist(),
        "torch_backend_total_ms_runs": runs["torch"], "kernel_path_wins": wins,
        "torch_backend_step_ms": torch_total_ms / REFINE_STEPS,
        "step_ms_saved_by_kernel": (torch_total_ms - total_ms) / REFINE_STEPS,
        "forward_kernel_ms_standalone": fwd_ms, "backward_ms_standalone": bwd_ms,
        "torch_autograd_backward_ms_standalone": torch_bwd_ms,
        "forward_kernel_share": fwd_step / step_ms, "backward_share": bwd_ms / step_ms,
        "rest_ms_per_step": step_ms - fwd_step - bwd_ms,
        "holograms_per_s": b / total_ms * 1e3,
    }


HEAD_WIDTHS = (64, 64)      # conv1_1 on the folded one-channel stem, conv1_2
TAIL_WIDTHS = halo_exp.TAIL_WIDTHS  # conv8, conv9, conv10
# The halo tail: block heights of scripts/exp_halo_conv.py, and the tail's
# input widths of the flagship (64) and the `ultra` release (16).
HALO_BH = (30, 60)
HALO_WIDTHS = (64, 16)
HALO_KERNELS = {"halo_conv_tail": halo_conv.halo_conv_tail,
                "halo_conv_tail_static": halo_conv.halo_conv_tail_static}
# Each kernel's row in scripts/port_exp_halo_conv.py.
HALO_ROWS = {"halo_conv_tail": "halo", "halo_conv_tail_static": "halo_static"}
# bf16 ulps of max|ref| allowed where the strips' conv differs by device.
HALO_EDGE_ULPS = 4
# Ragged shapes (B, C, H, W) of the tail's tensor-core tiles: the widths of
# `turbo` (24), `balanced` (48) and `ultra` (16), H and W off the 16 x 16
# tile (the tail takes H and W even); and 80 channels (a width-1.25 net),
# where the bf16 tail runs the SIMT body.
TAIL_ODD_SHAPES = ((2, 24, 32, 24), (2, 48, 20, 34), (1, 16, 20, 12), (1, 80, 20, 34))
# The head's: (B, C, width, H, W), one or three input channels, the
# releases' widths 16 (`ultra`), 24 (`turbo`), 32 (`fast`), 48
# (`balanced`), H and W off its 16 x 32 pre-pool tile; and width 80 (the
# SIMT body in bf16).
HEAD_ODD_SHAPES = ((2, 1, 16, 20, 34), (2, 3, 24, 34, 20), (2, 1, 32, 36, 40), (2, 1, 48, 128, 128),
                   (1, 3, 64, 20, 34), (1, 1, 80, 20, 34))
# The halo tail's: ((B, C, H, W), bh), W off the 16-column tile, the row
# tiles 12 and 16 rows high.
HALO_ODD_SHAPES = (((2, 24, 56, 34), 24), ((2, 48, 40, 20), 16))


def ring_args(b: int, dtype, layer, seed: int, device):
    c, h, w, o = layer
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, c, h, w, generator=g).to(device, dtype)
    k = (torch.randn(o, c, 3, 3, generator=g) * (2.0 / (9 * c)) ** 0.5).to(device, dtype)
    return x, k


def check_conv_kernels(device, batches=(5, 256)):
    """The stack kernels and the border ring against their plain versions."""
    rows = []
    cases = []
    for b, c, width, h, w in HEAD_ODD_SHAPES:
        for dtype in CONV_TOLERANCES:
            cases.append(("fused_encoder_head", b, dtype, (b, c, width, h, w),
                          lambda b=b, c=c, width=width, h=h, w=w, dt=dtype: seeded_stack(
                              b, dt, c, (width, width), b + c + width + h + w, device, size=(h, w)),
                          conv_stack.fused_encoder_head, conv_stack.encoder_head_plain))
    for shape in TAIL_ODD_SHAPES:
        for dtype in CONV_TOLERANCES:
            cases.append(("fused_conv_tail", shape[0], dtype, shape,
                          lambda shape=shape, dt=dtype: seeded_stack(
                              shape[0], dt, shape[1], (shape[1], shape[1], 2), sum(shape), device,
                              size=shape[2:]),
                          conv_stack.fused_conv_tail, conv_stack.conv_tail_plain))
    for b in batches:
        for dtype in CONV_TOLERANCES:
            cases.append(("fused_encoder_head", b, dtype, None,
                          lambda b=b, dt=dtype: seeded_stack(b, dt, 1, HEAD_WIDTHS, b, device),
                          conv_stack.fused_encoder_head, conv_stack.encoder_head_plain))
            cases.append(("fused_conv_tail", b, dtype, None,
                          lambda b=b, dt=dtype: seeded_stack(b, dt, 64, TAIL_WIDTHS, b, device),
                          conv_stack.fused_conv_tail, conv_stack.conv_tail_plain))
            for layer in RING_LAYERS:
                cases.append(("border_lines", b, dtype, layer,
                              lambda b=b, dt=dtype, layer=layer: ring_args(b, dt, layer, b, device),
                              reflect_border.border_lines, reflect_border.border_lines_plain))
    for name, b, dtype, layer, make, run, plain in cases:
        args = make()
        got, ref = run(*args), plain(*args)
        if name != "border_lines":
            got, ref = (got,), (ref,)
        torch.cuda.synchronize()
        err = max(float((g.float() - r.float()).abs().max()) for g, r in zip(got, ref))
        rel = max(rel_err(g.float(), r.float()) for g, r in zip(got, ref))
        row = {"kernel": name, "B": b, "dtype": _dt(dtype),
               "layer": layer, "tol": CONV_TOLERANCES[dtype],
               "max_abs_err": err, "rel_err_vs_plain": rel}
        rows.append(row)
        if not rel < CONV_TOLERANCES[dtype]:
            _die(f"kernel check failed: {json.dumps(row)}", 1)
        del args, got, ref
    return rows


def drive_halo(device):
    """The halo slice's path, as ``scripts/port_exp_halo_conv.py`` drives it:
    both entry points on one seeded flagship-width input at B = 256 in bf16,
    at each block height. Returns (args, outputs by kernel and bh)."""
    args = seeded_stack(B_TIMING, torch.bfloat16, 64, TAIL_WIDTHS, 3, device)
    outs = {(name, bh): fn(*args, bh=bh) for bh in HALO_BH for name, fn in HALO_KERNELS.items()}
    return args, outs


def check_halo_outputs(args, outs):
    """Finite outputs of the tail's shape that agree with the plain version
    on the first images."""
    b = args[0].shape[0]
    head = [a[:2] if i == 0 else a for i, a in enumerate(args)]
    for (name, bh), y in outs.items():
        if tuple(y.shape) != (b, 2, IMAGE, IMAGE) or not bool(torch.isfinite(y).all()):
            _die(f"halo output of {name} at bh {bh}: shape {tuple(y.shape)} or non-finite", 1)
        ref = halo_conv.halo_conv_tail_plain(*head, bh=bh).float()
        if not rel_err(y[:2].float(), ref) < CONV_TOLERANCES[torch.bfloat16]:
            _die(f"halo output of {name} at bh {bh} disagrees with the plain version", 1)


def check_halo_kernels(device, batches=(5, 256)):
    """Both halo kernels against ``halo_conv_tail_plain``, and their interior
    rows against ``fused_conv_tail`` on the same input: bit for bit in bf16
    (one tile body, one summation order a pixel), within the tolerance in
    fp32. At B = 5 and 256 on the flagship's square images, then at
    ``HALO_ODD_SHAPES``."""
    edge = halo_conv.EDGE
    rows = []
    cases = [((b, c, IMAGE, IMAGE), dtype, HALO_BH)
             for b in batches for dtype in CONV_TOLERANCES for c in HALO_WIDTHS]
    cases += [(shape, dtype, (bh,)) for shape, bh in HALO_ODD_SHAPES for dtype in CONV_TOLERANCES]
    for (b, c, h, w), dtype, bhs in cases:
        seed = b + c if (h, w) == (IMAGE, IMAGE) else b + c + h + w
        args = seeded_stack(b, dtype, c, (c, c, 2), seed, device, size=(h, w))
        tol = CONV_TOLERANCES[dtype]
        fused = conv_stack.fused_conv_tail(*args)[:, :, edge:-edge]
        for bh in bhs:
            plain = halo_conv.halo_conv_tail_plain(*args, bh=bh).float()
            for name, fn in HALO_KERNELS.items():
                got = fn(*args, bh=bh)
                torch.cuda.synchronize()
                inner = got[:, :, edge:-edge]
                row = {"kernel": name, "B": b, "dtype": _dt(dtype), "C": c, "bh": bh,
                       "shape": list(args[0].shape), "tol": tol,
                       "max_abs_err": float((got.float() - plain).abs().max()),
                       "rel_err_vs_plain": rel_err(got.float(), plain),
                       "interior_rel_err_vs_fused_tail": rel_err(inner.float(), fused.float()),
                       "interior_equals_fused_tail": bool(torch.equal(inner, fused))}
                rows.append(row)
                inner_ok = (row["interior_equals_fused_tail"] if dtype == torch.bfloat16
                            else row["interior_rel_err_vs_fused_tail"] < tol)
                if not (row["rel_err_vs_plain"] < tol and inner_ok):
                    _die(f"halo kernel check failed: {json.dumps(row)}", 1)
                del got, inner
            del plain
        del args, fused
    return rows


def check_halo_card_vs_cpu(device, b: int = 2, bh: int = HALO_BH[0]):
    """Both halo kernels and ``conv_tail_reference`` on the card against the
    port's CPU versions on the same inputs, which tests/test_torch_halo_conv.py
    holds to the JAX package. On the card the strips are cuDNN's convs in
    x's dtype, on the CPU fp32 convs rounded once; each then rounds the bias
    add. fp32: CONV_TOLERANCES throughout. bf16: the interior rows within
    CONV_TOLERANCES, the 4 + 4 edge rows and the whole reference within
    HALO_EDGE_ULPS bf16 ulps of max|ref| (the CPU tests' edge budget)."""
    edge = halo_conv.EDGE
    rows = []
    for dtype, tol in CONV_TOLERANCES.items():
        for c in HALO_WIDTHS:
            args = seeded_stack(b, dtype, c, (c, c, 2), 7 + c, device)
            cpu_args = [t.cpu() for t in args]
            plain = halo_conv.halo_conv_tail_plain(*cpu_args, bh=bh).float()
            ref = conv_stack.conv_tail_reference(*cpu_args).float()
            card_ref = conv_stack.conv_tail_reference(*args).float().cpu()
            row = {"B": b, "dtype": _dt(dtype), "C": c, "bh": bh, "tol": tol,
                   "edge_ulps_budget": HALO_EDGE_ULPS,
                   "reference_ulps": float((card_ref - ref).abs().max()) / bf16_ulp(ref),
                   "reference_rel_err": rel_err(card_ref, ref)}
            ok = (row["reference_ulps"] <= HALO_EDGE_ULPS if dtype == torch.bfloat16
                  else row["reference_rel_err"] < tol)
            for name, fn in HALO_KERNELS.items():
                got = fn(*args, bh=bh).float().cpu()
                inner, outer = got[:, :, edge:-edge], torch.cat([got[:, :, :edge], got[:, :, -edge:]], 2)
                p_inner = plain[:, :, edge:-edge]
                p_outer = torch.cat([plain[:, :, :edge], plain[:, :, -edge:]], 2)
                row[name] = {"interior_rel_err": rel_err(inner, p_inner),
                             "edge_rel_err": float((outer - p_outer).abs().max() / plain.abs().max()),
                             "edge_ulps": float((outer - p_outer).abs().max()) / bf16_ulp(plain)}
                ok = ok and row[name]["interior_rel_err"] < tol and (
                    row[name]["edge_ulps"] <= HALO_EDGE_ULPS if dtype == torch.bfloat16
                    else row[name]["edge_rel_err"] < tol)
            rows.append(row)
            if not ok:
                _die(f"halo tail on the card and the CPU disagree: {json.dumps(row)}", 1)
    return rows


def halo_bounds(peak_flops, peak_bytes, b: int):
    """Least time (ms) and what bounds it, by dtype, for the halo tail at
    flagship width: ``function`` is the entry point's function, the tail on
    all H rows (x read once, the output written once; the same as the fused
    tail's bound), ``interior`` the kernel's work alone (rows 4..H-5,
    reading input rows 1..H-2)."""
    macs_px = 9 * (64 * 64 + 64 * 64 + 64 * 2)
    h = w = IMAGE
    edge = halo_conv.EDGE
    out = {}
    for dtype, kind in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        size = 2 if dtype == torch.bfloat16 else 4
        weights = macs_px * size + 130 * 4
        for part, rows, in_rows in (("interior", h - 2 * edge, h - 2), ("function", h, h)):
            t_ops = 2 * macs_px * rows * w * b / peak_flops[kind] * 1e3
            t_bytes = ((64 * in_rows + 2 * rows) * w * size * b + weights) / peak_bytes * 1e3
            out[part, dtype] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
    return out


def time_halo(device):
    """CUDA-event medians at B = 256, by dtype: the rows of
    ``scripts/port_exp_halo_conv.py`` (its ``xla_tail``, the port's
    ``conv_tail_reference``, is the cuDNN composition of the tail), each
    kernel's launch alone, and the plain versions."""
    out = {}
    for dtype in CONV_TOLERANCES:
        a = seeded_stack(B_TIMING, dtype, 64, TAIL_WIDTHS, 2, device)
        t = {name: median_ms(fn, reps=7) for name, fn in halo_exp.rows(a, HALO_BH).items()}
        for bh in HALO_BH:
            for row, static in (("halo", False), ("halo_static", True)):
                t[f"{row}_interior_bh{bh}"] = median_ms(lambda: halo_conv.halo_interior(
                    *a, bh=bh, static=static), reps=7)
            t[f"plain_bh{bh}"] = median_ms(lambda: halo_conv.halo_conv_tail_plain(*a, bh=bh), reps=5)
            t[f"plain_interior_bh{bh}"] = median_ms(
                lambda: halo_conv.halo_interior_plain(*a, bh=bh), reps=5)
        out[_dt(dtype)] = t
        del a
    return out


def compare_outputs(got, ref, amp_tol, dist_tol, phase_tol, phase_fraction, label):
    """Two retrieval outputs of one batch: amp_foc relative to max|ref|,
    distance_pred absolute, the zero-meaned phase modulo 2 pi."""
    amp_err = rel_err(got["amp_foc"].cpu(), ref["amp_foc"].cpu())
    dist_err = float((got["distance_pred"].cpu() - ref["distance_pred"].cpu()).abs().max())
    dph = zero_mean(got["ph_foc"].cpu()) - zero_mean(ref["ph_foc"].cpu())
    wrapped = torch.remainder(dph - dph.flatten()[0] + math.pi, 2 * math.pi) - math.pi
    ok_frac = float((wrapped.abs() < phase_tol).float().mean())
    jumps = int(((dph.abs() > phase_tol) & (wrapped.abs() < phase_tol)).sum())
    result = {
        "amp_foc_rel_err": amp_err, "amp_tol": amp_tol,
        "distance_pred_abs_err": dist_err, "distance_tol": dist_tol,
        "ph_foc_frac_within_tol_mod_2pi": ok_frac, "phase_tol": phase_tol,
        "phase_fraction": phase_fraction, "ph_foc_2pi_jumps": jumps,
    }
    if not (amp_err < amp_tol and dist_err < dist_tol and ok_frac >= phase_fraction):
        _die(f"{label} disagree: {json.dumps(result)}", 1)
    return result


def _cpu(v):
    return v.cpu() if torch.is_tensor(v) else v


def _one_int8_step(x, act_max):
    """``x`` with one zero activation (after the relu; the middle one in
    memory order) set to one int8 step, act_max / 127: its quantized value
    goes from 0 to 1 and nothing else moves."""
    flat = x.clone().reshape(-1)
    zeros = (flat == 0).nonzero().reshape(-1)
    if zeros.numel() == 0:
        _die("the first int8 conv's input has no zero to move by one step", 1)
    flat[zeros[zeros.numel() // 2]] = float(act_max) / 127.0
    return flat.reshape(x.shape)


def run_recorded(net, args, scales, dt, device, one_step=False):
    """``retrieval_step`` on the int8 path with every call of QUANT_OPS
    recorded as (op, args, kwargs, output); ``one_step`` moves one activation
    of the first int8 conv's input by one int8 step."""
    calls = []
    real = {op: getattr(quant, op) for op in QUANT_OPS}

    def recording(op):
        def call(*a, **kw):
            if one_step and op == "int8_conv_valid" and not any(c[0] == op for c in calls):
                a = (_one_int8_step(a[0], kw["act_max"]),) + a[1:]
            y = real[op](*a, **kw)
            calls.append((op, a, kw, y))
            return y
        return call

    for op in QUANT_OPS:
        setattr(quant, op, recording(op))
    try:
        out = retrieval_step(net, *args, quant_scales=scales, quant_dtype=dt, device=device)
    finally:
        for op, fn in real.items():
            setattr(quant, op, fn)
    return out, calls


@torch.inference_mode()
def ops_on_cpu(calls, dt):
    """Each recorded call again on the CPU from the same inputs (the stack
    wrappers take their plain versions there). Returns, by op, the calls
    and the largest max|err| / max|ref|."""
    worst = {}
    for op, a, kw, y in calls:
        ref = getattr(quant, op)(*map(_cpu, a), **{k: _cpu(v) for k, v in kw.items()}).float()
        err = float((y.cpu().float() - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
        n, e = worst.get(op, (0, 0.0))
        worst[op] = (n + 1, max(e, err))
    return {op: {"calls": n, "rel_err": e} for op, (n, e) in worst.items()}


def divergence(calls, calls_ref):
    """Where two runs of the path part, call by call: the inputs' max|diff|
    / max|ref| and, at an int8 conv, how many quantized activations differ."""
    if [c[0] for c in calls] != [c[0] for c in calls_ref]:
        _die("two runs of the int8 path called different ops", 1)
    rows = []
    for (op, a, kw, _), (_, a_ref, _, _) in zip(calls, calls_ref):
        i = 1 if op == "_conv_fp" else 0  # _conv_fp(op, x, kernel, bias, dt)
        x, x_ref = a[i].cpu().float(), a_ref[i].cpu().float()
        row = {"op": op, "input_rel_diff": rel_err(x, x_ref)}
        if op == "int8_conv_valid":
            sx = torch.tensor(127.0) / torch.clamp(kw["act_max"].float().cpu(), min=1e-8)
            row["int8_steps_differ"] = int((quant._quantize(x, sx) != quant._quantize(x_ref, sx)).sum())
        rows.append(row)
    return rows


def output_diffs(got, ref):
    """amp_foc's max|err| / max|ref| and ||err|| / ||ref||, distance_pred's
    max|err|."""
    amp, amp_ref = got["amp_foc"].cpu(), ref["amp_foc"].cpu()
    return {
        "amp_foc_rel_err": rel_err(amp, amp_ref),
        "amp_foc_rel_l2": float((amp - amp_ref).norm() / amp_ref.norm()),
        "distance_pred_abs_err": float((got["distance_pred"].cpu() - ref["distance_pred"].cpu()).abs().max()),
    }


def int8_path_card_vs_cpu(net, net_cpu, args, scales, dt):
    """One golden batch of the int8 path on the card against the same port
    on the CPU: every op of the card's run again on the CPU from the same
    inputs, where the two runs part, what one int8 step moves, and the
    outputs."""
    got, calls = run_recorded(net, args, scales, dt, "cuda")
    ref, calls_ref = run_recorded(net_cpu, args, scales, dt, "cpu")
    stepped, calls_stepped = run_recorded(net, args, scales, dt, "cuda", one_step=True)
    ops = ops_on_cpu(calls, dt)
    trace = divergence(calls, calls_ref)
    result = {
        "ops_same_inputs": ops, "op_tol": CONV_TOLERANCES[dt],
        "card_vs_cpu_by_call": trace,
        "card_vs_cpu": output_diffs(got, ref),
        "one_int8_step": {
            "int8_steps_differ": divergence(calls_stepped, calls)[next(
                i for i, c in enumerate(calls) if c[0] == "int8_conv_valid")]["int8_steps_differ"],
            **output_diffs(stepped, got),
        },
        "tol": QUANT_PATH_TOL[dt],
    }
    held = (
        ops["int8_conv_valid"]["calls"] > 0 and ops["int8_conv_valid"]["rel_err"] == 0.0
        and all(v["rel_err"] < CONV_TOLERANCES[dt] for k, v in ops.items() if k != "int8_conv_valid")
        and result["one_int8_step"]["int8_steps_differ"] == 1
        and all(result["card_vs_cpu"][k] < t for k, t in QUANT_PATH_TOL[dt].items())
    )
    if not held:
        _die(f"int8 path ({_dt(dt)}) on the card and the CPU disagree: {json.dumps(result)}", 1)
    return result


def golden_contents(goldens):
    """The golden suite's sqrt-intensity batches, (B, 1, H, W) each."""
    return [np.sqrt(goldens.content_holo[i]) for i in range(goldens.n_batches)]


def suite_summary(metrics):
    for key in ("mean_psnr", "mean_mae", "r2"):
        if not math.isfinite(metrics[key]):
            _die(f"int8 suite metric {key} is not finite: {metrics[key]}", 1)
    return {k: metrics[k] for k in ("mean_psnr", "heldout_mean_psnr", "mean_mae", "r2")}


def ring_bound(peak_flops, peak_bytes, b: int, layer, dtype):
    """Least time (ms) of the ring at one layer (C, H, W, O) and what bounds
    it: 24 C O (H + W) fp32 FLOP an image (its taps are folded in fp32, so
    its products are fp32 in either type) against the eight edge lines it
    reads, its outputs and the kernel, each once."""
    c, h, w, o = layer
    size = 2 if dtype == torch.bfloat16 else 4
    t_ops = 24 * c * o * (h + w) * b / peak_flops["fp32"] * 1e3
    t_bytes = ((4 * (h + w) * c + 2 * o * (h + w)) * size * b + o * c * 9 * size) / peak_bytes * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def time_ring_step(step_layers, peak_flops, peak_bytes, b: int, device):
    """The ring at each reflect conv of one fp32 step, at batch b: by
    layer (C, H, W, O) its CUDA-event median, its bound and how many of the
    step's convs have that shape; and the step's sums."""
    by_layer = time_ring_layers(step_layers, b, device)
    for v in by_layer.values():
        v["bound_ms"], v["bound_by"] = ring_bound(peak_flops, peak_bytes, b, v.pop("layer"),
                                                  torch.float32)
    return {
        "by_layer": by_layer,
        "step_ms": sum(v["ms"] * v["convs"] for v in by_layer.values()),
        "step_bound_ms": sum(v["bound_ms"] * v["convs"] for v in by_layer.values()),
        "convs": sum(v["convs"] for v in by_layer.values()),
    }


def conv_bounds(peak_flops, peak_bytes, b: int):
    """Least time (ms) and what bounds it, for each conv kernel at batch b
    and dtype: the larger of its operations over the card's peak rate for
    their type (bf16 products with fp32 sums at the tensor cores' bf16 rate,
    fp32 at the fp32 rate) and its bytes (each input once, each output
    once) over the memory rate. The ring at the timed layer."""
    hw = IMAGE * IMAGE
    out = {}
    for dtype, kind in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        size = 2 if dtype == torch.bfloat16 else 4
        head_flops = 2 * hw * 9 * (1 * 64 + 64 * 64) * b
        head_bytes = (hw * 1 + 64 * hw // 4) * size * b + (64 * 9 + 64 * 64 * 9) * size + 128 * 4
        tail_flops = 2 * hw * 9 * (64 * 64 + 64 * 64 + 64 * 2) * b
        tail_bytes = (64 * hw + 2 * hw) * size * b + (2 * 64 * 64 * 9 + 2 * 64 * 9) * size + 130 * 4
        for name, flops, nbytes in (("fused_encoder_head", head_flops, head_bytes),
                                    ("fused_conv_tail", tail_flops, tail_bytes)):
            t_ops = flops / peak_flops[kind] * 1e3
            t_bytes = nbytes / peak_bytes * 1e3
            out[name, dtype] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
        out["border_lines", dtype] = ring_bound(peak_flops, peak_bytes, b, RING_LAYERS[0], dtype)
    return out


def main() -> int:
    with Phase("device") as phase:
        smi = phase_device()
        name = torch.cuda.get_device_name(0)
        phase.info = {
            "name": name, "nvidia_smi": smi, "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        }
        if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
            _die("TF32 is on: the port must run fp32 convolutions and products", 1)
        peak_fp32, peak_bf16, peak_bytes = next(
            (v for k, v in PEAKS.items() if k in name), PEAKS["H100"])
        peak_flops = {"fp32": peak_fp32, "bf16": peak_bf16}

    with Phase("build") as phase:
        removed = _build.remove_stale()
        seconds = _build.build(*_build.SOURCES)
        asm_cuda._lib()
        conv_stack._lib()
        reflect_border._lib()
        halo_conv._lib()
        phase.info = {"nvcc_seconds": seconds, "removed_stale": removed, "build_dir": _build.BUILD_DIR,
                      **{f"{src}_ptxas": _build.ptxas_lines(src) for src in _build.SOURCES}}

    with open(os.path.join(REPO, "checkpoints", "config.json")) as f:
        cfg = ExperimentConfig.from_json(f.read())
    physics = cfg.physics
    dev = torch.device("cuda")

    with Phase("kernels") as phase:
        rows = check_kernels(physics, dev)
        conv_rows = check_conv_kernels(dev)
        phase.info = {"checks": rows, "conv_checks": conv_rows}

    with Phase("slice") as phase:
        goldens = load_golden_suite()
        net = seeded_weights_(StyleTransferNet(width=cfg.model.width), seed=0).to(dev).eval()
        asm_cuda.reset_launches()
        metrics, out = drive_slice(net, goldens, cfg, dev)
        torch.cuda.synchronize()
        launches = dict(asm_cuda.LAUNCHES)
        if not all(launches[k] > 0 for k in ("asm_const", "asm_dynamic")):
            _die(f"the main path did not launch every kernel: {launches}", 1)
        check_slice_outputs(metrics, out, goldens.batch_size)
        card_vs_cpu = compare_card_cpu(net, goldens, cfg, batch=10)
        phase.info = {
            "width": cfg.model.width, "launches": launches,
            "mean_psnr_random_weights": metrics["mean_psnr"],
            "r2_random_weights": metrics["r2"],
            "card_vs_cpu": card_vs_cpu,
        }

    with Phase("refine") as phase:
        grad_rows = check_function_grads(physics, dev)
        anchored = refine_card_vs_cpu(goldens, physics, dev)
        asm_cuda.reset_launches()
        t0 = time.monotonic()
        refined = evaluate_golden_suite(net, goldens, cfg, refine_steps=REFINE_STEPS, device=dev)
        torch.cuda.synchronize()
        suite_seconds = time.monotonic() - t0
        refine_launches = dict(asm_cuda.LAUNCHES)
        want = goldens.n_batches * (REFINE_STEPS + 1)
        if refine_launches["asm_dynamic"] != want:
            _die(f"the refined suite launched asm_dynamic {refine_launches['asm_dynamic']} times, "
                 f"want {want}", 1)
        for key in ("mean_psnr", "mean_mae", "r2", "heldout_mean_psnr"):
            if not math.isfinite(refined[key]):
                _die(f"refined suite metric {key} is not finite: {refined[key]}", 1)
        refine_timing = time_refine(goldens, physics, dev)
        phase.info = {
            "gradient_checks": grad_rows, "card_vs_cpu_batch_10": anchored,
            "launches": refine_launches, "refined_suite_seconds": suite_seconds,
            "refined_mean_psnr_random_weights": refined["mean_psnr"],
            "unrefined_mean_psnr_random_weights": metrics["mean_psnr"],
            "timing": refine_timing,
        }

    with Phase("quant") as phase:
        scales = quant.calibrate_scales(
            net, golden_contents(goldens), goldens.style_mean, goldens.style_std, device=dev)
        bf16 = torch.bfloat16
        quant.set_fused_stacks("on")
        conv_stack.reset_launches()
        metrics_on = evaluate_golden_suite(
            net, goldens, cfg, quant_scales=scales, dtype=bf16, device=dev)
        torch.cuda.synchronize()
        launches.update(conv_stack.LAUNCHES)
        if not all(launches[k] > 0 for k in conv_stack.LAUNCHES):
            _die(f"the int8 path did not launch both stack kernels: {conv_stack.LAUNCHES}", 1)
        tc_launches = dict(conv_stack.TC_LAUNCHES)
        if tc_launches != conv_stack.LAUNCHES:
            _die(f"the int8 path ran a stack off the tensor cores: {tc_launches} of "
                 f"{conv_stack.LAUNCHES}", 1)
        args = (goldens.content_holo[10], goldens.style_mean, goldens.style_std,
                float(goldens.distance_style[10].reshape(-1)[0]), physics)
        net_cpu = copy.deepcopy(net).cpu()
        quant_card_vs_cpu = {
            _dt(dt): int8_path_card_vs_cpu(net, net_cpu, args, scales, dt)
            for dt in (torch.float32, bf16)
        }
        no_int8 = [retrieval_step(n, *args, quant_scales={}, quant_dtype=torch.float32, device=d)
                   for n, d in ((net, "cuda"), (net_cpu, "cpu"))]
        quant_card_vs_cpu["float32_no_int8"] = compare_outputs(
            *no_int8, SLICE_AMP_TOL, SLICE_DIST_TOL, SLICE_PHASE_TOL, SLICE_PHASE_FRACTION,
            "the stacks-on path without int8 convs on the card and the CPU")
        quant.set_fused_stacks("off")
        metrics_off = evaluate_golden_suite(
            net, goldens, cfg, quant_scales=scales, dtype=bf16, device=dev)
        quant.set_fused_stacks("auto")
        phase.info = {
            "n_scales": len(scales),
            "launches": {k: launches[k] for k in conv_stack.LAUNCHES},
            "tensor_core_launches": tc_launches,
            "stacks_on_random_weights": suite_summary(metrics_on),
            "stacks_off_random_weights": suite_summary(metrics_off),
            "fp32_random_weights": {"mean_psnr": metrics["mean_psnr"], "r2": metrics["r2"]},
            "card_vs_cpu_batch_10": quant_card_vs_cpu,
        }

    with Phase("reflect") as phase:
        args = (goldens.content_holo[10], goldens.style_mean, goldens.style_std,
                float(goldens.distance_style[10].reshape(-1)[0]), physics)
        set_reflect_backend("cuda")
        reflect_border.reset_launches()
        with recording_ring_layers() as ring_layers_of_step:
            r_cuda = retrieval_step(net, *args, device=dev)
        torch.cuda.synchronize()
        launches.update(reflect_border.LAUNCHES)
        set_reflect_backend("matpad")
        r_matpad = retrieval_step(net, *args, device=dev)
        set_reflect_backend("auto")
        if launches["border_lines"] != REFLECT_CONVS:
            _die(f"the ring launched {launches['border_lines']} times a step, want {REFLECT_CONVS}", 1)
        # Two fp32 conv algorithms on the card: the tolerances of card vs CPU.
        phase.info = {
            "launches_per_step": launches["border_lines"],
            "ring_layers_of_step": ring_layers_of_step,
            "cuda_vs_matpad_batch_10": compare_outputs(
                r_cuda, r_matpad, SLICE_AMP_TOL, SLICE_DIST_TOL, SLICE_PHASE_TOL,
                SLICE_PHASE_FRACTION, "reflect backends cuda and matpad"),
        }

    with Phase("halo") as phase:
        halo_conv.reset_launches()
        halo_args, halo_outs = drive_halo(dev)
        torch.cuda.synchronize()
        launches.update(halo_conv.LAUNCHES)
        if not all(launches[k] > 0 for k in halo_conv.LAUNCHES):
            _die(f"the halo path did not launch both kernels: {halo_conv.LAUNCHES}", 1)
        check_halo_outputs(halo_args, halo_outs)
        del halo_args, halo_outs
        halo_rows = check_halo_kernels(dev)
        halo_card_vs_cpu = check_halo_card_vs_cpu(dev)
        halo_ms = time_halo(dev)
        halo_b = halo_bounds(peak_flops, peak_bytes, B_TIMING)
        phase.info = {
            "launches": {k: launches[k] for k in halo_conv.LAUNCHES},
            "checks": halo_rows, "card_vs_cpu": halo_card_vs_cpu, "B": B_TIMING, "ms": halo_ms,
            "bound_ms": {f"{p}/{_dt(d)}": v for (p, d), v in halo_b.items()},
        }

    with Phase("timing") as phase:
        kw = dict(wavelength=physics.wavelength, pixel_size=physics.pixel_size)
        b = B_TIMING
        xre, xim = random_planes(b, seed=1, device=dev)
        field = torch.complex(xre, xim)
        dist = spread_distances(b, dev)
        timings = {
            "asm_const": (
                median_ms(lambda: asm_cuda.asm_const(xre, xim, SERVING_REFOCUS_M, **kw)),
                median_ms(lambda: asm_cuda.asm_const_plain(xre, xim, SERVING_REFOCUS_M, **kw)),
                median_ms(lambda: propagate_torch(field, SERVING_REFOCUS_M, **kw)),
            ),
            "asm_dynamic": (
                median_ms(lambda: asm_cuda.asm_dynamic(xre, xim, dist, **kw)),
                median_ms(lambda: asm_cuda.asm_dynamic_plain(xre, xim, dist, **kw)),
                median_ms(lambda: propagate_torch(field, dist.reshape(b, 1, 1), **kw)),
            ),
        }
        holo = torch.as_tensor(
            goldens.content_holo.reshape(-1, 1, IMAGE, IMAGE)[np.arange(b) % 100], device=dev
        )
        step = lambda: retrieval_step(  # noqa: E731
            net, holo, goldens.style_mean, goldens.style_std, 0.2, physics, device=dev)
        step_ms = median_ms(step, reps=5, warmup=2)
        by_precision = {
            prec: {
                "asm_const": median_ms(lambda: asm_cuda.asm_const(
                    xre, xim, SERVING_REFOCUS_M, precision=prec, **kw), reps=7),
                "asm_dynamic": median_ms(lambda: asm_cuda.asm_dynamic(
                    xre, xim, dist, precision=prec, **kw), reps=7),
            }
            for prec in TOLERANCES
        }
        # The step's stages, each timed alone on the same batch: the net
        # (encoder, AdaIN, decoder, distance head), the refocus (field,
        # propagate by -d_style, |.| and angle) and the unwrap.
        sm, ss = split_style_vector(
            np.concatenate([goldens.style_mean, goldens.style_std]).astype(np.float32))
        sm, ss = sm.to(dev), ss.to(dev)
        with torch.inference_mode():
            content = torch.sqrt(holo)
            amp_t, ph_t, _ = net.field_retrieval(content, sm, ss, unknown_distance=True)
            _, ph_foc = holo_forward(amp_t, ph_t, -0.2, physics, return_field=True)
            stages_ms = {
                "net": median_ms(lambda: net.field_retrieval(
                    content, sm, ss, unknown_distance=True), reps=5, warmup=1),
                "refocus": median_ms(lambda: holo_forward(
                    amp_t, ph_t, -0.2, physics, return_field=True), reps=5, warmup=1),
                "unwrap": median_ms(lambda: unwrap_phase(ph_foc), reps=5, warmup=1),
            }
        # The conv kernels: kernel, plain version and library call (the cuDNN
        # composition of the same stack in the same dtype, for the tail the
        # port's conv_tail_reference; the ring has no
        # single PyTorch call), bf16 (the int8 path's dtype) and fp32; the
        # ring at the decoder's 128^2 64->64 layer, and in fp32 at each
        # checked layer.
        conv_timings = {}
        for dtype in CONV_TOLERANCES:
            for kname, c_in, widths, run, plain, lib in (
                ("fused_encoder_head", 1, HEAD_WIDTHS, conv_stack.fused_encoder_head,
                 conv_stack.encoder_head_plain, head_library),
                ("fused_conv_tail", 64, TAIL_WIDTHS, conv_stack.fused_conv_tail,
                 conv_stack.conv_tail_plain, conv_stack.conv_tail_reference),
            ):
                a = seeded_stack(b, dtype, c_in, widths, 2, dev)
                conv_timings[kname, dtype] = (
                    median_ms(lambda: run(*a), reps=7), median_ms(lambda: plain(*a), reps=5),
                    median_ms(lambda: lib(*a), reps=7))
                del a
            x, k = ring_args(b, dtype, RING_LAYERS[0], 2, dev)
            conv_timings["border_lines", dtype] = (
                median_ms(lambda: reflect_border.border_lines(x, k)),
                median_ms(lambda: reflect_border.border_lines_plain(x, k), reps=7), None)
        ring_layers_ms = {}
        for layer in RING_LAYERS:
            x, k = ring_args(b, torch.float32, layer, 2, dev)
            ring_layers_ms["x".join(map(str, layer))] = median_ms(lambda: reflect_border.border_lines(x, k))
        del x, k
        ring_step = time_ring_step(ring_layers_of_step, peak_flops, peak_bytes, b, dev)
        conv_b = conv_bounds(peak_flops, peak_bytes, b)

        # retrieval_step in int8 with the stacks on, and its stages alone on
        # the same batch; then fp32 with the reflect backend cuda.
        bf16 = torch.bfloat16
        quant.set_fused_stacks("on")
        q_step = lambda: retrieval_step(  # noqa: E731
            net, holo, goldens.style_mean, goldens.style_std, 0.2, physics,
            quant_scales=scales, device=dev)
        q_step_ms = median_ms(q_step, reps=5, warmup=2)
        qkw = dict(scales=scales, compute_dtype=bf16)
        with torch.inference_mode():
            feat = quant.quant_encode(net.encoder, content, **qkw)
            t_feat = adain_with_stats(feat, sm, ss)
            g_out = quant.quant_decode(net.decoder, t_feat, **qkw)
            q_amp, q_ph = g_out[:, 0:1], g_out[:, 1:2]
            _, q_ph_foc = holo_forward(q_amp, q_ph, -0.2, physics, return_field=True)
            q_stages_ms = {
                "encoder": median_ms(lambda: quant.quant_encode(net.encoder, content, **qkw),
                                   reps=5, warmup=1),
                "adain": median_ms(lambda: adain_with_stats(feat, sm, ss), reps=5, warmup=1),
                "decoder": median_ms(lambda: quant.quant_decode(net.decoder, t_feat, **qkw),
                                   reps=5, warmup=1),
                "distance_head": median_ms(lambda: net.distance_g(calc_mean_std(feat), dtype=bf16),
                                         reps=5, warmup=1),
                "refocus": median_ms(lambda: holo_forward(
                    q_amp, q_ph, -0.2, physics, return_field=True), reps=5, warmup=1),
                "unwrap": median_ms(lambda: unwrap_phase(q_ph_foc), reps=5, warmup=1),
            }
        # The same step and its network stages with the stacks off (the
        # default, as in the JAX package), on the same batch.
        quant.set_fused_stacks("off")
        q_off_step_ms = median_ms(q_step, reps=5, warmup=2)
        with torch.inference_mode():
            feat_off = quant.quant_encode(net.encoder, content, **qkw)
            t_off = adain_with_stats(feat_off, sm, ss)
            q_off_stages_ms = {
                "encoder": median_ms(lambda: quant.quant_encode(net.encoder, content, **qkw),
                                   reps=5, warmup=1),
                "decoder": median_ms(lambda: quant.quant_decode(net.decoder, t_off, **qkw),
                                   reps=5, warmup=1),
            }
        quant.set_fused_stacks("auto")
        set_reflect_backend("cuda")
        r_step_ms = median_ms(step, reps=5, warmup=2)
        set_reflect_backend("auto")

        # The least time for one propagate of b images, in each precision
        # mode: the larger of its operations over the card's peak rate for
        # their type and the bytes (x and y planes, factors, transfer
        # planes, distances; each once) over its memory rate.
        h = w = IMAGE
        fh, fw = 2 * h, 2 * w
        cmacs = fh * h * w + fh * w * fw + h * fh * fw + h * fw * w
        flops = 8.0 * cmacs * b
        factor_bytes = 4 * 2 * (fh * h + w * fw + h * fh + fw * w)
        io_bytes = 4 * 2 * 2 * b * h * w + factor_bytes
        bytes_by = {"asm_const": io_bytes + 4 * 2 * fh * fw, "asm_dynamic": io_bytes + 4 * fh * fw + 4 * b}
        bounds = {}
        for k in timings:
            for prec, (n_products, kind) in PRODUCTS.items():
                t_ops = n_products * flops / peak_flops[kind] * 1e3
                t_bytes = bytes_by[k] / peak_bytes * 1e3
                bounds[k, prec] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
        phase.info = {
            "B": b, "precision": "high",
            "kernel_ms": {k: v[0] for k, v in timings.items()},
            "plain_ms": {k: v[1] for k, v in timings.items()},
            "torch_fft_ms": {k: v[2] for k, v in timings.items()},
            "bound_ms": {k: bounds[k, "high"][0] for k in timings},
            "peak_flops": peak_flops, "peak_bytes_per_s": peak_bytes,
            "kernel_ms_by_precision": by_precision,
            "bound_ms_by_precision": {
                prec: {k: bounds[k, prec][0] for k in timings} for prec in PRODUCTS},
            "retrieval_step_ms": step_ms, "retrieval_holograms_per_s": b / step_ms * 1e3,
            "step_stages_ms": stages_ms,
            "int8_stacks_on_step_ms": q_step_ms,
            "int8_stacks_on_holograms_per_s": b / q_step_ms * 1e3,
            "int8_stacks_on_stages_ms": q_stages_ms,
            "int8_stacks_off_step_ms": q_off_step_ms,
            "int8_stacks_off_holograms_per_s": b / q_off_step_ms * 1e3,
            "int8_stacks_off_stages_ms": q_off_stages_ms,
            "fp32_reflect_cuda_step_ms": r_step_ms,
            "fp32_reflect_cuda_holograms_per_s": b / r_step_ms * 1e3,
            "conv_kernel_ms": {f"{k}/{_dt(d)}": v for (k, d), v in conv_timings.items()},
            "ring_fp32_ms_by_layer": ring_layers_ms,
            "ring_fp32_step": ring_step,
            "conv_bound_ms": {f"{k}/{_dt(d)}": v for (k, d), v in conv_b.items()},
        }

    sources = "style_transfer_based_holographic_imaging_tpu_torch/kernels/csrc/asm_propagate.cu"
    replaces = {
        "asm_const": "style_transfer_based_holographic_imaging_tpu/kernels/asm_pallas.py:212",
        "asm_dynamic": "style_transfer_based_holographic_imaging_tpu/kernels/asm_pallas.py:252",
    }
    kernels = []
    for k in ("asm_const", "asm_dynamic"):
        mine = [r for r in rows if r["kernel"] == k]
        at_default = [r for r in mine if r["shape"] == [b, IMAGE, IMAGE] and r["precision"] == "high"][0]
        kernels.append({
            "name": k, "route": "cuda", "source": sources, "replaces": replaces[k],
            "launches": launches[k],
            "max_abs_err": at_default["max_abs_err"],
            "max_rel_err": max(r["rel_err_vs_plain"] for r in mine if r["precision"] == "high"),
            "tol": TOLERANCES["high"],
            "rel_err_by_precision": {
                p: max(r["rel_err_vs_plain"] for r in mine if r["precision"] == p)
                for p in TOLERANCES
            },
            "tol_by_precision": TOLERANCES,
            "ms": timings[k][0], "plain_ms": timings[k][1],
            "bound_ms": bounds[k, "high"][0], "bound_by": bounds[k, "high"][1],
            "ms_by_precision": {p: by_precision[p][k] for p in PRODUCTS},
            "bound_ms_by_precision": {p: bounds[k, p][0] for p in PRODUCTS},
            "library_ms": timings[k][2],
            "launches_by_path": {"slice": launches[k], "refine": refine_launches[k]},
            **({"refine_step_ms": refine_timing["step_ms"],
                "refine_step_ms_torch_backend": refine_timing["torch_backend_step_ms"],
                "refine_forward_share": refine_timing["forward_kernel_share"]}
               if k == "asm_dynamic" else {}),
        })
    csrc = "style_transfer_based_holographic_imaging_tpu_torch/kernels/csrc/"
    jk = "style_transfer_based_holographic_imaging_tpu/kernels/"
    conv_meta = {
        # name: (source, replaces, the dtype of its path)
        "fused_encoder_head": (csrc + "conv_stack.cu", jk + "conv_stack.py:195", torch.bfloat16),
        "fused_conv_tail": (csrc + "conv_stack.cu", jk + "conv_stack.py:122", torch.bfloat16),
        "border_lines": (csrc + "reflect_border.cu", jk + "reflect_border.py:97", torch.float32),
    }
    extras = {
        "border_lines": {"step_fp32_ms": ring_step["step_ms"],
                         "step_fp32_bound_ms": ring_step["step_bound_ms"],
                         "step_convs": ring_step["convs"]},
    }
    for k, (source, where, dt) in conv_meta.items():
        mine = [r for r in conv_rows if r["kernel"] == k]
        at = [r for r in mine if r["B"] == b and r["dtype"] == _dt(dt)
              and r["layer"] in (None, RING_LAYERS[0])][0]
        kernels.append({
            "name": k, "route": "cuda", "source": source, "replaces": where,
            "launches": launches[k], "dtype": _dt(dt),
            "max_abs_err": at["max_abs_err"],
            "max_rel_err": max(r["rel_err_vs_plain"] for r in mine if r["dtype"] == _dt(dt)),
            "tol": CONV_TOLERANCES[dt],
            "rel_err_by_dtype": {
                _dt(d): max(r["rel_err_vs_plain"] for r in mine if r["dtype"] == _dt(d))
                for d in CONV_TOLERANCES
            },
            "tol_by_dtype": {_dt(d): t for d, t in CONV_TOLERANCES.items()},
            "ms": conv_timings[k, dt][0], "plain_ms": conv_timings[k, dt][1],
            "bound_ms": conv_b[k, dt][0], "bound_by": conv_b[k, dt][1],
            "ms_by_dtype": {_dt(d): conv_timings[k, d][0] for d in CONV_TOLERANCES},
            "plain_ms_by_dtype": {_dt(d): conv_timings[k, d][1] for d in CONV_TOLERANCES},
            "bound_ms_by_dtype": {_dt(d): conv_b[k, d][0] for d in CONV_TOLERANCES},
            "library_ms": conv_timings[k, dt][2],
            "library_ms_by_dtype": {_dt(d): conv_timings[k, d][2] for d in CONV_TOLERANCES},
            **extras.get(k, {}),
        })
    halo_where = {"halo_conv_tail": jk + "halo_conv.py:105",
                  "halo_conv_tail_static": jk + "halo_conv.py:175"}
    bf16, bh = torch.bfloat16, HALO_BH[0]
    for k, where in halo_where.items():
        mine = [r for r in halo_rows if r["kernel"] == k]
        at = [r for r in mine if r["B"] == b and r["dtype"] == _dt(bf16) and r["C"] == 64
              and r["bh"] == bh][0]
        kernels.append({
            "name": k, "route": "cuda", "source": csrc + "halo_conv.cu", "replaces": where,
            "launches": launches[k], "dtype": _dt(bf16), "bh": bh, "C": 64,
            "max_abs_err": at["max_abs_err"],
            "max_rel_err": max(r["rel_err_vs_plain"] for r in mine if r["dtype"] == _dt(bf16)),
            "tol": CONV_TOLERANCES[bf16],
            "rel_err_by_dtype": {
                _dt(d): max(r["rel_err_vs_plain"] for r in mine if r["dtype"] == _dt(d))
                for d in CONV_TOLERANCES
            },
            "tol_by_dtype": {_dt(d): t for d, t in CONV_TOLERANCES.items()},
            "ms": halo_ms[_dt(bf16)][f"{HALO_ROWS[k]}_bh{bh}"],
            "plain_ms": halo_ms[_dt(bf16)][f"plain_bh{bh}"],
            "bound_ms": halo_b["function", bf16][0], "bound_by": halo_b["function", bf16][1],
            "library_ms": halo_ms[_dt(bf16)]["xla_tail"],
            "interior_ms": halo_ms[_dt(bf16)][f"{HALO_ROWS[k]}_interior_bh{bh}"],
            "interior_plain_ms": halo_ms[_dt(bf16)][f"plain_interior_bh{bh}"],
            "interior_bound_ms": halo_b["interior", bf16][0],
            "ms_by_dtype_bh": {f"{d}/bh{h}": halo_ms[d][f"{HALO_ROWS[k]}_bh{h}"]
                               for d in halo_ms for h in HALO_BH},
            "bound_ms_by_dtype": {_dt(d): halo_b["function", d][0] for d in CONV_TOLERANCES},
        })
    emit({"wall_seconds": round(time.monotonic() - _t_start, 3)})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    watchdog = threading.Timer(TOTAL_BUDGET_S + 5.0, _die, args=("the run overran its total budget", 3))
    watchdog.daemon = True
    watchdog.start()
    code = main()
    watchdog.cancel()
    sys.exit(code)
