"""Time the ASM wrappers' host cost a launch on one CUDA card.

Imports the port from ``--root`` (this checkout by default), so one call
can time two checkouts in turns (parent, change, change, parent). At each
``--batch``, on seeded uniform (B, 128, 128) re/im planes, ``asm_const``
at the golden suite's refocus distance and ``asm_dynamic`` at distances
over +-0.8 mm, both at the default precision, no profiler recording:

* ``sync_ms``: the CUDA-event median of one call after a synchronize
  (what ``port_exp_asm.py --time`` and ``chip_smoke.py`` report: the
  host's time before the launch counts);
* ``stream_ms``: the CUDA-event time of ``--calls`` calls back to back,
  a call: the larger of the host's and the card's time a call;
* ``host_us``: the host clock around the same calls, before the
  synchronize: the wrapper's host time a call.

Medians over ``--reps`` rounds. Prints one JSON line with the card's name
and power limit; exits 2 without a card.

    python scripts/port_exp_asm_host.py [--batch 5 --batch 32] [--calls 500] [--root DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--batch", type=int, action="append", help="B (repeatable; default 5 and 32)")
ap.add_argument("--calls", type=int, default=500)
ap.add_argument("--reps", type=int, default=7)
ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                help="the checkout whose port is timed")
ARGS = ap.parse_args()
sys.path.insert(0, os.path.abspath(ARGS.root))

import torch  # noqa: E402

from style_transfer_based_holographic_imaging_tpu_torch.kernels import _build, asm_cuda  # noqa: E402

KW = dict(wavelength=532e-9, pixel_size=1.5e-6)
REFOCUS_M = -2e-4
SIZE = 128


def sync_ms(fn) -> float:
    times = []
    for _ in range(ARGS.reps * 3):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def stream(fn) -> tuple[float, float]:
    dev_ms, host_us = [], []
    for _ in range(ARGS.reps):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(ARGS.calls):
            fn()
        t1 = time.perf_counter()
        end.record()
        end.synchronize()
        dev_ms.append(start.elapsed_time(end) / ARGS.calls)
        host_us.append((t1 - t0) / ARGS.calls * 1e6)
    return statistics.median(dev_ms), statistics.median(host_us)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: the kernels run on a card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30).stdout.strip()
    _build.build("asm_propagate")
    dev = torch.device("cuda")
    rows = {}
    for b in ARGS.batch or (5, 32):
        g = torch.Generator().manual_seed(0)
        xre = torch.rand(b, SIZE, SIZE, generator=g).to(dev)
        xim = torch.rand(b, SIZE, SIZE, generator=g).to(dev)
        dist = torch.linspace(-8e-4, 8e-4, b, device=dev)
        for name, fn in (("asm_const", lambda: asm_cuda.asm_const(xre, xim, REFOCUS_M, **KW)),
                         ("asm_dynamic", lambda: asm_cuda.asm_dynamic(xre, xim, dist, **KW))):
            for _ in range(10):
                fn()
            stream_ms, host_us = stream(fn)
            rows[f"{name}/B{b}"] = {"sync_ms": sync_ms(fn), "stream_ms": stream_ms, "host_us": host_us}
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "root": os.path.abspath(ARGS.root), "calls": ARGS.calls, "reps": ARGS.reps,
                      "profiler_recording": torch.autograd._profiler_enabled(), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
