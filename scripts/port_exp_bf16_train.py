"""Mixed-precision training's numerics on the card: how far its gradients sit
from the float64 ones and why, and where a ``remat`` step parts from a plain
one.

    python3 scripts/port_exp_bf16_train.py [--parts ops,remat,grads] [--batches 8]
    python3 scripts/port_exp_bf16_train.py --cpu --width 0.25 --image 64 --batches 2   # rehearsal

Parts (one JSON line each on stdout; everything also to ``--out``):

* ``ops`` — one bf16 3x3 conv at layer shapes of the training step: its
  output (fprop), its input's gradient (dgrad) and its weight's (wgrad) on
  the card (cuDNN in bf16, as the port's bf16 step runs them; then again
  with ``cudnn.deterministic``) and by the port's CPU rule (the fp32 conv of
  the bf16 operands, rounded once to bf16), each against a float64
  evaluation of the same bf16 operands: the share of elements equal to the
  float64 value rounded to bf16, the largest and the mean error in bf16
  ulps of each element (and the shares within 1 ulp and the 99.9th
  percentile), the relative L2 error. A conv that sums in fp32 and rounds
  once is within 0.5 ulp plus the fp32 sum's error (large in ulps only
  where the sum cancels to near zero).
* ``remat`` — the flagship's step at ``--remat-batch``, dropout on, fp32
  ``matpad``, bf16 ``matpad`` and bf16 with the ``cuda`` ring, without and
  with ``cudnn.deterministic``: the gradients of two plain and two
  ``remat`` steps (largest difference over a leaf's max, pair by pair);
  then, in one ``remat`` step, every conv module's input and output in the
  forward against the same call in the recompute (which runs on autograd's
  device thread), and the net's forward in a second host thread against
  the main thread's.
* ``grads`` — the flagship's step at B = 2 on ``--batches`` batches: each
  leaf's L2 distance from the float64 gradient over its norm
  (``chip_smoke.grad_distances``) for the card's bf16 step (``matpad``, the
  ``cuda`` ring, ``cudnn.deterministic``), the CPU's, and a control one bit
  coarser than bf16: the card's step with every conv's output, and the
  gradient into it, rounded to 7 significant bits instead of bf16's 8
  (``chip_smoke.one_bit_coarser_convs``); and ``chip_smoke``'s check of
  these distances (``bf16_distance_shares``) over all the batches.
* ``det`` — plain and ``remat`` steps at ``--remat-batch`` under
  ``torch.use_deterministic_algorithms(True)``, ``matpad`` and the
  ``cuda`` ring, fp32 and bf16: the op that has no deterministic version,
  or the steps' differences.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time

import torch
import torch.nn.functional as F
from torch import nn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from style_transfer_based_holographic_imaging_tpu_torch import ExperimentConfig  # noqa: E402
from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite, synth  # noqa: E402
from style_transfer_based_holographic_imaging_tpu_torch.models import (  # noqa: E402
    PatchDiscriminator,
    StyleTransferNet,
    init_net_params,
    init_params,
    set_reflect_backend,
)
from style_transfer_based_holographic_imaging_tpu_torch.models.layers import ConvTranspose2x2  # noqa: E402
from style_transfer_based_holographic_imaging_tpu_torch.train import generator_loss_fn  # noqa: E402


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


cs = _load_smoke()
BF16 = torch.bfloat16
# (B, C, H, W, O): encoder conv1_2, conv2_2, conv3_x, conv4_1's input width;
# the last at the card-against-CPU check's B = 2.
OP_SHAPES = ((32, 64, 128, 128, 64), (32, 128, 64, 64, 128), (32, 256, 32, 32, 256),
             (32, 512, 16, 16, 512), (2, 64, 128, 128, 64))


@contextlib.contextmanager
def deterministic(on: bool):
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = on
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = was


def ulp_stats(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """``got`` against the float64 ``ref``: the share equal to ``ref``
    rounded to bf16, the largest and mean error in bf16 ulps of each
    element of ``ref``, the relative L2 error."""
    got, ref = got.detach().double().cpu(), ref.detach().double().cpu()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
    ulps = (got - ref).abs() / ulp
    return {"exact_share": float((got == ref.to(BF16).double()).double().mean()),
            "within_1ulp_share": float((ulps <= 1.0).double().mean()),
            "p999_ulps": float(torch.quantile(ulps.flatten()[::max(1, ulps.numel() // 1_000_000)].float(), 0.999)),
            "max_ulps": float(ulps.max()), "mean_ulps": float(ulps.mean()),
            "rel_l2": float((got - ref).norm() / ref.norm())}


def conv_paths(x, k, up, device):
    """(y, dx, dk) of the bf16 conv of ``x`` and ``k`` with the upstream
    gradient ``up``: float64, the card, the card deterministic, the CPU
    rule."""
    out = {}
    for path in ("float64", "card", "card_deterministic", "cpu"):
        dev = "cpu" if path == "cpu" else device
        dt = torch.float64 if path == "float64" else BF16
        xs, ks = x.to(dev, dt).requires_grad_(), k.to(dev, dt).requires_grad_()
        with deterministic(path == "card_deterministic"):
            if path == "float64":
                y = F.conv2d(xs, ks, padding=1)
                g = up.to(dev).double()
            elif path == "cpu":
                y = F.conv2d(xs.float(), ks.float(), padding=1).to(BF16)
                g = up
            else:
                y = F.conv2d(xs, ks, padding=1)
                g = up.to(dev)
            dx, dk = torch.autograd.grad(y, (xs, ks), g)
        out[path] = (y, dx, dk)
    return out


def part_ops(device) -> list:
    rows = []
    for b, c, h, w, o in OP_SHAPES:
        g = torch.Generator().manual_seed(c + h + b)
        x = torch.randn(b, c, h, w, generator=g).to(BF16)
        k = (torch.randn(o, c, 3, 3, generator=g) * (2.0 / (9 * c)) ** 0.5).to(BF16)
        up = torch.randn(b, o, h, w, generator=g).to(BF16)
        paths = conv_paths(x, k, up, device)
        ref = paths.pop("float64")
        row = {"shape": [b, c, h, w, o]}
        for path, got in paths.items():
            row[path] = {name: ulp_stats(a, r) for name, a, r in zip(("fprop", "dgrad", "wgrad"), got, ref)}
        rows.append(row)
        print(json.dumps({"op": row}), flush=True)
    return rows


def max_rel_diff(a: dict, b: dict) -> dict:
    """The largest |a - b| over the leaf's max |b| over every leaf of both
    groups, its leaf, and the count of leaves that differ at all."""
    worst, leaf, differ = 0.0, None, 0
    for group in b:
        for k in b[group]:
            d = float((a[group][k] - b[group][k]).abs().max())
            differ += d > 0
            r = d / max(float(b[group][k].abs().max()), 1e-30)
            if r > worst:
                worst, leaf = r, f"{group}/{k}"
    return {"max_rel": worst, "leaf": leaf, "leaves_differing": differ}


def with_remat(cfg, remat: bool, dropout: bool = True):
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, remat=remat, use_dropout=dropout))


def capture_recompute(cfg, params, disc_params, batch, device, dtype, backend) -> dict:
    """One ``remat`` step with every conv module's calls recorded: each call
    of the forward against the same module's call in the recompute."""
    set_reflect_backend(backend)
    net = StyleTransferNet(width=cfg.model.width).to(device)
    disc = PatchDiscriminator(image_size=cfg.data.image_size).to(device)
    names = {m: n for n, m in net.named_modules()}
    calls = []

    def hook(module, args, out):
        calls.append((names[module], threading.get_ident(), args[0].detach().clone(), out.detach().clone()))

    handles = [m.register_forward_hook(hook) for m in net.modules() if isinstance(m, (nn.Conv2d, ConvTranspose2x2))]
    p = {k: v.to(device).requires_grad_() for k, v in params.items()}
    dp = {k: v.to(device) for k, v in disc_params.items()}
    b = {k: v.to(device) for k, v in batch.items()}
    try:
        loss, _ = generator_loss_fn(p, b, net=net, physics=cfg.physics, cfg=cfg.train, disc=disc,
                                    disc_params=dp, dropout=synth.stream_generator(cfg.data.seed + 2, 0),
                                    dtype=dtype)
        n_forward = len(calls)
        torch.autograd.grad(loss, list(p.values()))
    finally:
        for h in handles:
            h.remove()
        set_reflect_backend("auto")
    forward, recompute = calls[:n_forward], calls[n_forward:]
    seen, by_key = {}, {}
    for name, tid, x, y in forward:
        i = seen[name] = seen.get(name, -1) + 1
        by_key[(name, i)] = (tid, x, y)
    seen, rows = {}, []
    for name, tid, x, y in recompute:
        i = seen[name] = seen.get(name, -1) + 1
        ftid, fx, fy = by_key[(name, i)]
        rows.append({"module": name, "call": i, "same_thread": tid == ftid, "input_equal": bool(torch.equal(x, fx)),
                     "output_equal": bool(torch.equal(y, fy)),
                     "output_max_abs_diff": float((y.double() - fy.double()).abs().max())})
    first = next((r for r in rows if not r["output_equal"]), None)
    return {"dtype": cs._dt(dtype), "backend": backend, "forward_calls": n_forward,
            "recompute_calls": len(recompute), "recompute_on_other_thread": all(not r["same_thread"] for r in rows),
            "outputs_differing": sum(not r["output_equal"] for r in rows),
            "inputs_differing": sum(not r["input_equal"] for r in rows),
            "first_differing": first, "rows_differing": [r for r in rows if not r["output_equal"]][:12]}


def thread_forward(cfg, params, batch, device, dtype, backend) -> dict:
    """The net's forward (no grad, dropout off) in the main thread, again
    in the main thread, and in a second host thread: bit for bit?"""
    set_reflect_backend(backend)
    net = StyleTransferNet(width=cfg.model.width).to(device)
    p = {k: v.to(device) for k, v in params.items()}
    content, style = batch["content_holo"].to(device), batch["style_holo"].to(device)

    def run():
        with torch.no_grad():
            out = torch.func.functional_call(net, p, (content, style, 1.0), {"dtype": dtype})
        torch.cuda.synchronize() if content.is_cuda else None
        return {k: v.detach().clone() for k, v in out.items() if torch.is_tensor(v)}

    main, again = run(), run()
    box = {}
    t = threading.Thread(target=lambda: box.setdefault("out", run()))
    t.start()
    t.join()
    set_reflect_backend("auto")
    eq = lambda a, b: all(torch.equal(a[k], b[k]) for k in a)  # noqa: E731
    return {"dtype": cs._dt(dtype), "backend": backend, "main_again_equal": eq(main, again),
            "other_thread_equal": eq(main, box["out"])}


def part_remat(cfg, bank, device, b: int) -> dict:
    run = cs._train_cfg(cfg, batch_size=b)
    params = init_net_params(torch.Generator().manual_seed(0), width=cfg.model.width)
    disc_params = init_params(PatchDiscriminator(image_size=cfg.data.image_size), torch.Generator().manual_seed(1))
    batch = synth.synth_batch(0, torch.as_tensor(bank), run.data, cfg.physics, return_gt=True)
    configs = ((torch.float32, "matpad"), (BF16, "matpad"), (BF16, "cuda"))
    out = {"B": b, "steps": {}, "recompute": [], "threads": []}
    for det in (False, True):
        for dtype, backend in configs:
            t0 = time.monotonic()
            with deterministic(det):
                g = [cs.step_gradients(with_remat(run, r), params, disc_params, batch, device, backend=backend,
                                       compute=dtype) for r in (False, False, True, True)]
            row = {"dtype": cs._dt(dtype), "backend": backend, "cudnn_deterministic": det,
                   "plain_vs_plain": max_rel_diff(g[1], g[0]), "remat_vs_remat": max_rel_diff(g[3], g[2]),
                   "remat_vs_plain": max_rel_diff(g[2], g[0]), "seconds": time.monotonic() - t0}
            out["steps"][f"{row['dtype']}_{backend}{'_det' if det else ''}"] = row
            print(json.dumps({"remat_steps": row}), flush=True)
    for dtype, backend in configs:
        rec = capture_recompute(with_remat(run, True), params, disc_params, batch, device, dtype, backend)
        thr = thread_forward(run, params, batch, device, dtype, backend)
        out["recompute"].append(rec)
        out["threads"].append(thr)
        print(json.dumps({"recompute": rec, "threads": thr}), flush=True)
    return out


def part_grads(cfg, bank, device, batches: int) -> dict:
    small = cs._train_cfg(cfg, batch_size=2)
    params = init_net_params(torch.Generator().manual_seed(0), width=cfg.model.width)
    disc_params = init_params(PatchDiscriminator(image_size=cfg.data.image_size), torch.Generator().manual_seed(1))
    paths = ("card", "cpu", "cuda_ring", "card_deterministic", "coarse_control")
    dist = {p: [] for p in paths}
    sizes = None
    for i in range(batches):
        t0 = time.monotonic()
        batch = synth.synth_batch(i, torch.as_tensor(bank), small.data, cfg.physics, return_gt=True)
        args = (small, params, disc_params, batch)
        anchor = cs.step_gradients(*args, device, torch.float64)
        sizes = sizes or {f"{g}/{k}": v.numel() for g, t in anchor.items() for k, v in t.items()}
        for path in paths:
            dev = "cpu" if path == "cpu" else device
            ctx = cs.one_bit_coarser_convs() if path == "coarse_control" else contextlib.nullcontext()
            with ctx, deterministic(path == "card_deterministic"):
                g = cs.step_gradients(*args, dev, backend="cuda" if path == "cuda_ring" else "matpad", compute=BF16)
            dist[path].append(cs.grad_distances(g, anchor))
        print(json.dumps({"grads_batch": i, "seconds": time.monotonic() - t0,
                          "median_over_leaves": {p: sorted(dist[p][-1].values())[len(dist[p][-1]) // 2]
                                                 for p in paths}}), flush=True)
    checks = {f"{p}_vs_{y}": cs.bf16_distance_shares(dist[p], dist[y])
              for p, y in (("card", "cpu"), ("cuda_ring", "card"), ("coarse_control", "cpu"))}
    print(json.dumps({"grads_checks_all_batches": checks}), flush=True)
    return {"B": 2, "batches": batches, "leaf_sizes": sizes, "rel_distances": dist, "checks": checks}


def part_det(cfg, bank, device, b: int) -> dict:
    """Plain and ``remat`` steps at B = ``b`` under
    ``torch.use_deterministic_algorithms(True)``: the op that has no
    deterministic version, or the steps' differences."""
    run = cs._train_cfg(cfg, batch_size=b)
    params = init_net_params(torch.Generator().manual_seed(0), width=cfg.model.width)
    disc_params = init_params(PatchDiscriminator(image_size=cfg.data.image_size), torch.Generator().manual_seed(1))
    batch = synth.synth_batch(0, torch.as_tensor(bank), run.data, cfg.physics, return_gt=True)
    rows = []
    for dtype, backend in ((torch.float32, "matpad"), (BF16, "matpad"), (torch.float32, "cuda"), (BF16, "cuda")):
        row = {"dtype": cs._dt(dtype), "backend": backend}
        torch.use_deterministic_algorithms(True)
        try:
            g = [cs.step_gradients(with_remat(run, r), params, disc_params, batch, device, backend=backend,
                                   compute=dtype) for r in (False, False, True, True)]
            row.update(plain_vs_plain=max_rel_diff(g[1], g[0]), remat_vs_remat=max_rel_diff(g[3], g[2]),
                       remat_vs_plain=max_rel_diff(g[2], g[0]))
        except RuntimeError as e:
            row["error"] = str(e).splitlines()[0][:300]
        finally:
            torch.use_deterministic_algorithms(False)
            set_reflect_backend("auto")
        rows.append(row)
        print(json.dumps({"deterministic_algorithms": row}), flush=True)
    return {"B": b, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", default="ops,remat,grads,det")
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--remat-batch", type=int, default=32)
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out", "bf16_numerics.json"))
    ap.add_argument("--cpu", action="store_true", help="rehearse on the CPU (every path on the CPU)")
    ap.add_argument("--width", type=float, default=None, help="the net's width (default the flagship's)")
    ap.add_argument("--image", type=int, default=None, help="the canvas (default the flagship's)")
    args = ap.parse_args(argv)
    # cuBLAS is deterministic under torch.use_deterministic_algorithms only
    # with this workspace setting, read when its first handle is made.
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    device = torch.device("cpu" if args.cpu else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    with open(os.path.join(REPO, "checkpoints", "config.json")) as f:
        cfg = ExperimentConfig.from_json(f.read())
    if args.width is not None:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, width=args.width))
    size = 64
    if args.image is not None:
        cfg = cs._train_cfg(cfg, image_size=args.image, digit_pad=args.image // 4)
        size = args.image // 2
    bank = synth.golden_digit_bank(load_golden_suite(), size=size, subset=synth.GOLDEN_TRAIN_DIGITS)
    if device.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip()
        print(smi, flush=True)
    out = {"device": str(device), "width": cfg.model.width, "image": cfg.data.image_size}
    parts = args.parts.split(",")
    if "ops" in parts:
        out["ops"] = part_ops(device)
    if "remat" in parts:
        out["remat"] = part_remat(cfg, bank, device, args.remat_batch)
    if "grads" in parts:
        out["grads"] = part_grads(cfg, bank, device, args.batches)
    if "det" in parts:
        out["det"] = part_det(cfg, bank, device, args.remat_batch)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f)
    print(json.dumps({"written": os.path.relpath(args.out, REPO)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
