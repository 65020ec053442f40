"""Time the port's halo row-block decoder tail against the cuDNN composition
of the tail and the fused whole-image tail, on one CUDA card.

The PyTorch port's counterpart of scripts/exp_halo_conv.py, importing the
port only. Rows, each on the same seeded input (B, 64, 128, 128):

* ``xla_tail``: the port's ``conv_tail_reference``, the cuDNN composition
  of the three reflect convs in the input's dtype;
* ``fused_whole_image``: the port's ``fused_conv_tail`` kernel;
* ``halo_bh{bh}`` / ``halo_static_bh{bh}``: ``halo_conv_tail`` and
  ``halo_conv_tail_static`` for each ``--bh``.

Timing: the median of ``--reps`` CUDA-event timed calls after ``--warmup``
calls (on the CPU, with ``--cpu``, the host clock: the kernels' plain
versions, no device number). Weights: He-normal kernels (std
sqrt(2 / fan_in)) and N(0, 0.01^2) biases from ``torch.Generator`` seed
``--seed``, since the release's orbax weights cannot be read without JAX.
Prints one JSON line with the device, the times and the largest
difference of each halo row from ``xla_tail`` on the first two images.

    python scripts/port_exp_halo_conv.py [--batch 256] [--bh 30 --bh 60] \
        [--dtype bf16|fp32] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from style_transfer_based_holographic_imaging_tpu_torch.kernels import conv_stack, halo_conv  # noqa: E402
from style_transfer_based_holographic_imaging_tpu_torch.utils.bench import (  # noqa: E402
    median_ms,
    seeded_stack,
)

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
TAIL_WIDTHS = (64, 64, 2)  # conv8, conv9, conv10 at flagship width


def rows(a, bhs):
    """The experiment's rows on the tail's arguments ``a``: name -> call."""
    out = {
        "xla_tail": lambda: conv_stack.conv_tail_reference(*a),
        "fused_whole_image": lambda: conv_stack.fused_conv_tail(*a),
    }
    for bh in bhs:
        out[f"halo_bh{bh}"] = lambda bh=bh: halo_conv.halo_conv_tail(*a, bh=bh)
    for bh in bhs:
        out[f"halo_static_bh{bh}"] = lambda bh=bh: halo_conv.halo_conv_tail_static(*a, bh=bh)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--bh", type=int, action="append", default=None)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true", help="the plain versions on the CPU")
    args = ap.parse_args()
    bhs = args.bh or [30, 60]
    if args.cpu:
        device, kind = torch.device("cpu"), "cpu"
    else:
        if not torch.cuda.is_available():
            print("no CUDA device: pass --cpu to run the plain versions", file=sys.stderr)
            return 2
        device, kind = torch.device("cuda"), torch.cuda.get_device_name(0)
    cuda = device.type == "cuda"

    a = seeded_stack(args.batch, DTYPES[args.dtype], 64, TAIL_WIDTHS, args.seed, device)
    ms = {name: median_ms(fn, args.reps, args.warmup, cuda) for name, fn in rows(a, bhs).items()}

    head = [a[0][:2]] + a[1:]
    ref = conv_stack.conv_tail_reference(*head).float()
    parity = {}
    for bh in bhs:
        for name, fn in (("halo", halo_conv.halo_conv_tail),
                         ("halo_static", halo_conv.halo_conv_tail_static)):
            parity[f"{name}_bh{bh}"] = float((fn(*head, bh=bh).float() - ref).abs().max())
    print(json.dumps({
        "device": kind, "batch": args.batch, "dtype": args.dtype,
        "ms": ms, "parity_max_abs_vs_xla_tail": parity,
        "note": "3-conv decoder tail (128^2, C=64 -> 2), CUDA-event medians" if cuda
        else "3-conv decoder tail (128^2, C=64 -> 2), plain versions, host clock",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
