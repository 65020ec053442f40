"""Time the encoder head's kernel and the border ring, alone and in the
retrieval step, on one CUDA card.

Imports the port from ``--root`` (this checkout by default), so one call
can time two checkouts in turns (parent, change, change, parent) through
the entry points both have. Rows, at ``--batch`` on seeded inputs:

* ``head``: ``fused_encoder_head`` at the int8 path's shape (B, 1, 128,
  128) -> (B, 64, 64, 64), bf16 and fp32, beside the cuDNN composition of
  the same two convs and pool in the same dtype;
* ``ring``: ``border_lines`` at the decoder's 128^2 64->64 layer (fp32 and
  bf16) and the decoder's 16^2 512->256 layer (fp32), and at each of the
  20 reflect convs of one flagship fp32 step (their shapes recorded from a
  forward pass with the ``cuda`` border backend), summed over the step;
* ``steps`` (with ``--steps``): ``retrieval_step`` of the flagship-width
  net on seeded weights, fp32 with the ``matpad`` and with the ``cuda``
  border, and the int8 path in bf16 with the fused stacks on (scales
  calibrated on the golden suite).

CUDA-event medians. The measurement helpers (``utils/bench.py``) are this
checkout's, loaded by path, so that both checkouts are measured alike; the
kernels and the net are ``--root``'s. Prints one JSON line with the card's
name and power limit.

    python scripts/port_exp_head_ring.py [--batch 256] [--steps] [--root DIR]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--batch", type=int, default=256)
ap.add_argument("--reps", type=int, default=9)
ap.add_argument("--steps", action="store_true", help="also time the retrieval step three ways")
ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                help="the checkout whose port is timed")
ARGS = ap.parse_args()
sys.path.insert(0, os.path.abspath(ARGS.root))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from style_transfer_based_holographic_imaging_tpu_torch.kernels import conv_stack, reflect_border  # noqa: E402

_spec = importlib.util.spec_from_file_location("bench", os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "style_transfer_based_holographic_imaging_tpu_torch", "utils", "bench.py"))
bench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench)

HEAD_WIDTHS = (64, 64)
RING_TIMED = {"128x128_64to64": (64, 128, 128, 64), "16x16_512to256": (512, 16, 16, 256)}
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def time_head(b: int, reps: int, dev) -> dict:
    out = {}
    for name, dt in DTYPES.items():
        a = bench.seeded_stack(b, dt, 1, HEAD_WIDTHS, 2, dev)
        out[name] = {"kernel": bench.median_ms(lambda: conv_stack.fused_encoder_head(*a), reps=reps),
                     "cudnn": bench.median_ms(lambda: bench.head_library(*a), reps=reps)}
        del a
    return out


def seeded_net(dev):
    from style_transfer_based_holographic_imaging_tpu_torch.models import ConvTranspose2x2, StyleTransferNet

    net = StyleTransferNet(width=1.0)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear, ConvTranspose2x2)):
                fan_in = m.weight.shape[0] if isinstance(m, ConvTranspose2x2) else m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) * (2.0 / fan_in) ** 0.5)
                m.bias.copy_(0.01 * torch.randn(m.bias.shape, generator=g))
    return net.to(dev).eval()


def step_ring_layers(net, dev) -> list:
    """(C, H, W, O) of every ring launch of one forward pass at 128^2."""
    from style_transfer_based_holographic_imaging_tpu_torch.models import set_reflect_backend

    set_reflect_backend("cuda")
    try:
        with bench.recording_ring_layers() as seen, torch.inference_mode():
            content = torch.rand(1, 1, 128, 128, device=dev)
            net.decoder(net.encoder(content))
    finally:
        set_reflect_backend("auto")
    return seen


def time_ring(net, b: int, reps: int, dev) -> dict:
    out = {}
    for name, layer in RING_TIMED.items():
        for dn, dt in DTYPES.items():
            if name != "128x128_64to64" and dt != torch.float32:
                continue
            x, k = bench.ring_inputs(b, layer, 3, dev, dt)
            out[f"{name}/{dn}"] = bench.median_ms(lambda: reflect_border.border_lines(x, k), reps=reps)
            del x, k
    layers = step_ring_layers(net, dev)
    by_layer = bench.time_ring_layers(layers, b, dev, reps=reps)
    out["step_convs"] = len(layers)
    out["step_fp32_by_layer"] = {key: [v["ms"], v["convs"]] for key, v in by_layer.items()}
    out["step_fp32_sum"] = sum(v["ms"] * v["convs"] for v in by_layer.values())
    return out


def time_steps(net, b: int, dev) -> dict:
    from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite
    from style_transfer_based_holographic_imaging_tpu_torch.models import quant, set_reflect_backend
    from style_transfer_based_holographic_imaging_tpu_torch.pipelines import retrieval_step
    from style_transfer_based_holographic_imaging_tpu_torch import ExperimentConfig

    goldens = load_golden_suite()
    with open(os.path.join(ARGS.root, "checkpoints", "config.json")) as f:
        physics = ExperimentConfig.from_json(f.read()).physics
    holo = torch.as_tensor(goldens.content_holo.reshape(-1, 1, 128, 128)[np.arange(b) % 100], device=dev)
    scales = quant.calibrate_scales(
        net, [np.sqrt(goldens.content_holo[i]) for i in range(goldens.n_batches)],
        goldens.style_mean, goldens.style_std, device=dev)

    def step(**kw):
        return bench.median_ms(lambda: retrieval_step(net, holo, goldens.style_mean, goldens.style_std, 0.2,
                                                physics, device=dev, **kw), reps=5, warmup=2)

    out = {}
    set_reflect_backend("matpad")
    out["fp32_matpad"] = step()
    set_reflect_backend("cuda")
    out["fp32_cuda_ring"] = step()
    set_reflect_backend("auto")
    quant.set_fused_stacks("on")
    out["int8_stacks_on"] = step(quant_scales=scales)
    quant.set_fused_stacks("auto")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the kernels on a card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    dev = torch.device("cuda")
    net = seeded_net(dev)
    line = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "root": os.path.abspath(ARGS.root),
            "batch": ARGS.batch, "head_ms": time_head(ARGS.batch, ARGS.reps, dev),
            "ring_ms": time_ring(net, ARGS.batch, ARGS.reps, dev)}
    if ARGS.steps:
        line["step_ms"] = time_steps(net, ARGS.batch, dev)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
