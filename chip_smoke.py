#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card, and check it.

    python3 chip_smoke.py

Phases, each under its own wall-clock budget (a phase that overruns prints a
line naming it and ends the run with exit code 3; nothing hangs):

1. ``device``  — a CUDA card must be present (else exit 2); prints the card's
   name and power limit (``nvidia-smi``) and the TF32 flags.
2. ``build``   — removes stale build files, compiles the kernels' source with
   ``nvcc``, loads the library with ``ctypes``.
3. ``kernels`` — each kernel against its plain PyTorch version and against
   the ``torch.fft`` composition, at B = 5 and B = 256, in every precision
   mode, with per-sample distances spread over the suite's range for
   ``asm_dynamic``. Tolerance on max|err| / max|ref|: 1e-5 (highest),
   1e-4 (high), 2e-2 (bf16), the JAX package's budgets.
4. ``slice``   — the flagship-width net (width 1.0) on weights drawn from
   ``torch.Generator`` seed 0: the whole 20 x 5 golden suite through
   ``evaluate_golden_suite`` and one ``retrieval_step`` with per-sample style
   distances, with the launch counts reset just before and read just after;
   both kernels must have launched. Then one golden batch on the card
   against the same port on the CPU.
5. ``timing``  — CUDA-event medians at B = 256 of each kernel, its plain
   version and the ``torch.fft`` composition, and of the whole
   ``retrieval_step`` (holograms/s).

Then the ``nvidia-smi`` line, one JSON line listing every kernel, and the
final JSON line ``{"ok": true, "device": {...}}``. Any failure exits
non-zero before that line. The script imports the port, torch, numpy and the
standard library only.
"""

from __future__ import annotations

import copy
import json
import math
import os
import statistics
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
from style_transfer_based_holographic_imaging_tpu_torch.eval import zero_mean  # noqa: E402
from style_transfer_based_holographic_imaging_tpu_torch.kernels import _build, asm_cuda  # noqa: E402
from style_transfer_based_holographic_imaging_tpu_torch.models import (  # noqa: E402
    ConvTranspose2x2,
    StyleTransferNet,
    split_style_vector,
)
from style_transfer_based_holographic_imaging_tpu_torch.ops import holo_forward, unwrap_phase  # noqa: E402
from style_transfer_based_holographic_imaging_tpu_torch.ops.asm import propagate_torch  # noqa: E402
from style_transfer_based_holographic_imaging_tpu_torch.pipelines import (  # noqa: E402
    evaluate_golden_suite,
    retrieval_step,
)

TOTAL_BUDGET_S = 285.0
BUDGETS_S = {"device": 60.0, "build": 150.0, "kernels": 60.0, "slice": 90.0, "timing": 60.0}
TOLERANCES = {"highest": 1e-5, "high": 1e-4, "bf16": 2e-2}
# Card tolerances for the same golden batch on the card (cuDNN fp32 convs,
# the "high" DFT kernel) against the CPU (fp32 convs, the torch.fft path):
# max|err| / max|ref| of amp_foc, |err| of distance_pred (in (0, 1)), and the
# phase compared modulo 2 pi (the congruence snap may move a pixel at a tie
# by a whole 2 pi) in at least PHASE_FRACTION of the pixels.
SLICE_AMP_TOL = 1e-3
SLICE_DIST_TOL = 1e-4
SLICE_PHASE_TOL = 1e-2
SLICE_PHASE_FRACTION = 0.999
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


def rel_err(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


def cuda_ms(fn, reps: int = 15, warmup: int = 3) -> float:
    """Median over ``reps`` calls of CUDA-event time, in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def check_kernels(physics, device, batches=(5, 256)):
    """Each kernel against its plain version and the torch.fft composition."""
    kw = dict(wavelength=physics.wavelength, pixel_size=physics.pixel_size)
    rows = []
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
                    "kernel": name, "B": b, "precision": prec, "tol": tol,
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
    amp_err = rel_err(gpu["amp_foc"].cpu(), cpu["amp_foc"])
    dist_err = float((gpu["distance_pred"].cpu() - cpu["distance_pred"]).abs().max())
    dph = zero_mean(gpu["ph_foc"].cpu()) - zero_mean(cpu["ph_foc"])
    wrapped = torch.remainder(dph - dph.flatten()[0] + math.pi, 2 * math.pi) - math.pi
    ok_frac = float((wrapped.abs() < SLICE_PHASE_TOL).float().mean())
    jumps = int(((dph.abs() > SLICE_PHASE_TOL) & (wrapped.abs() < SLICE_PHASE_TOL)).sum())
    result = {
        "batch": batch, "amp_foc_rel_err": amp_err, "amp_tol": SLICE_AMP_TOL,
        "distance_pred_abs_err": dist_err, "distance_tol": SLICE_DIST_TOL,
        "ph_foc_frac_within_tol_mod_2pi": ok_frac, "phase_tol": SLICE_PHASE_TOL,
        "ph_foc_2pi_jumps": jumps,
    }
    if not (amp_err < SLICE_AMP_TOL and dist_err < SLICE_DIST_TOL
            and ok_frac >= SLICE_PHASE_FRACTION):
        _die(f"card and CPU disagree on the slice: {json.dumps(result)}", 1)
    return result


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
        seconds = _build.build("asm_propagate")
        asm_cuda._lib()
        phase.info = {"nvcc_seconds": seconds, "removed_stale": removed, "build_dir": _build.BUILD_DIR}

    with open(os.path.join(REPO, "checkpoints", "config.json")) as f:
        cfg = ExperimentConfig.from_json(f.read())
    physics = cfg.physics
    dev = torch.device("cuda")

    with Phase("kernels") as phase:
        rows = check_kernels(physics, dev)
        phase.info = {"checks": rows}

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

    with Phase("timing") as phase:
        kw = dict(wavelength=physics.wavelength, pixel_size=physics.pixel_size)
        b = B_TIMING
        xre, xim = random_planes(b, seed=1, device=dev)
        field = torch.complex(xre, xim)
        dist = spread_distances(b, dev)
        timings = {
            "asm_const": (
                cuda_ms(lambda: asm_cuda.asm_const(xre, xim, SERVING_REFOCUS_M, **kw)),
                cuda_ms(lambda: asm_cuda.asm_const_plain(xre, xim, SERVING_REFOCUS_M, **kw)),
                cuda_ms(lambda: propagate_torch(field, SERVING_REFOCUS_M, **kw)),
            ),
            "asm_dynamic": (
                cuda_ms(lambda: asm_cuda.asm_dynamic(xre, xim, dist, **kw)),
                cuda_ms(lambda: asm_cuda.asm_dynamic_plain(xre, xim, dist, **kw)),
                cuda_ms(lambda: propagate_torch(field, dist.reshape(b, 1, 1), **kw)),
            ),
        }
        holo = torch.as_tensor(
            goldens.content_holo.reshape(-1, 1, IMAGE, IMAGE)[np.arange(b) % 100], device=dev
        )
        step = lambda: retrieval_step(  # noqa: E731
            net, holo, goldens.style_mean, goldens.style_std, 0.2, physics, device=dev)
        step_ms = cuda_ms(step, reps=5, warmup=2)
        by_precision = {
            prec: {
                "asm_const": cuda_ms(lambda: asm_cuda.asm_const(
                    xre, xim, SERVING_REFOCUS_M, precision=prec, **kw), reps=7),
                "asm_dynamic": cuda_ms(lambda: asm_cuda.asm_dynamic(
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
                "net": cuda_ms(lambda: net.field_retrieval(
                    content, sm, ss, unknown_distance=True), reps=5, warmup=1),
                "refocus": cuda_ms(lambda: holo_forward(
                    amp_t, ph_t, -0.2, physics, return_field=True), reps=5, warmup=1),
                "unwrap": cuda_ms(lambda: unwrap_phase(ph_foc), reps=5, warmup=1),
            }
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
        }

    sources = "style_transfer_based_holographic_imaging_tpu_torch/kernels/csrc/asm_propagate.cu"
    replaces = {
        "asm_const": "style_transfer_based_holographic_imaging_tpu/kernels/asm_pallas.py:212",
        "asm_dynamic": "style_transfer_based_holographic_imaging_tpu/kernels/asm_pallas.py:252",
    }
    kernels = []
    for k in ("asm_const", "asm_dynamic"):
        mine = [r for r in rows if r["kernel"] == k]
        at_default = [r for r in mine if r["B"] == b and r["precision"] == "high"][0]
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
