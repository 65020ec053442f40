#!/usr/bin/env python3
"""Which ``torch.distributed`` collectives the ``gloo`` backend carries on
CUDA tensors, two ranks sharing ``cuda:0`` (the layout of ``chip_smoke.py``'s
``parallel`` phase), and on the CPU beside it.

    python3 scripts/port_probe_gloo_cuda.py [--cpu]

One world of two ranks (``parallel.launch``) tries each collective in turn
and reports "ok" or the first line of its error; send/recv runs last, in a
world of its own, since on CUDA tensors gloo can abort the process there
(the launch then reports the rank's exit code). Prints one JSON line:
torch's version, the card (``nvidia-smi``'s name and power limit) and, per
device, each operation's outcome. ``--cpu`` probes the CPU alone.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from style_transfer_based_holographic_imaging_tpu_torch import parallel  # noqa: E402

OPS = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor", "reduce_scatter",
       "reduce_scatter_tensor", "reduce", "gather", "all_to_all_single", "barrier")


def _run(op: str, device: torch.device) -> None:
    n, rank = dist.get_world_size(), dist.get_rank()
    x = torch.arange(4.0 * n, device=device) + rank
    if op == "all_reduce":
        dist.all_reduce(x)
    elif op == "broadcast":
        dist.broadcast(x, 0)
    elif op == "all_gather":
        dist.all_gather([torch.empty_like(x) for _ in range(n)], x)
    elif op == "all_gather_into_tensor":
        dist.all_gather_into_tensor(torch.empty(n * x.numel(), device=device), x)
    elif op == "reduce_scatter":
        dist.reduce_scatter(torch.empty(4, device=device), list(x.chunk(n)))
    elif op == "reduce_scatter_tensor":
        dist.reduce_scatter_tensor(torch.empty(4, device=device), x)
    elif op == "reduce":
        dist.reduce(x, 0)
    elif op == "gather":
        dist.gather(x, [torch.empty_like(x) for _ in range(n)] if rank == 0 else None, 0)
    elif op == "all_to_all_single":
        dist.all_to_all_single(torch.empty_like(x), x)
    elif op == "barrier":
        dist.barrier()
    elif op == "send_recv":
        if rank == 0:
            dist.send(x, 1)
        else:
            dist.recv(x, 0)
    if device.type == "cuda":
        torch.cuda.synchronize()


def probe_rank(rank: int, ops, device_name: str) -> dict:
    device = torch.device(device_name)
    out = {}
    for op in ops:
        try:
            _run(op, device)
            out[op] = "ok"
        except RuntimeError as e:
            out[op] = f"{type(e).__name__}: {str(e).splitlines()[0][:240]}"
    return out


def probe(device_name: str) -> dict:
    mesh = parallel.make_mesh(devices=[device_name] * 2)
    out = {}
    for ops in (OPS, ("send_recv",)):
        try:
            out.update(parallel.launch(probe_rank, mesh, ops, device_name, timeout=120.0)[0])
        except (RuntimeError, TimeoutError) as e:
            out.update({op: f"world failed: {str(e).splitlines()[0][:240]}" for op in ops})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="probe the CPU alone")
    args = ap.parse_args()
    devices = ["cpu"] if args.cpu else ["cuda:0", "cpu"]
    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA card (--cpu probes the CPU alone)", file=sys.stderr)
        return 2
    card = None
    if not args.cpu:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    print(json.dumps({"torch": torch.__version__, "card": card,
                      "gloo": {d: probe(d) for d in devices}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
