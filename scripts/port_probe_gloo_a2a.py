#!/usr/bin/env python3
"""Whether the ``gloo`` backend carries ``all_to_all_single`` with even and
uneven split sizes on CUDA tensors, two ranks sharing ``cuda:0`` (the layout
of ``chip_smoke.py``'s ``parallel`` phase), and on the CPU beside it.

    python3 scripts/port_probe_gloo_a2a.py [--cpu]

The mesh layer's ``all_to_all`` (the FOV-sharded refocus's transpose) sends
equal chunks to every rank; its ``ppermute`` (the pipeline's ring) sends a
rank's whole buffer to one peer and nothing to the others, and a rank with
no peer sends or receives nothing at all. Each case runs on float32 and on a
complex64 tensor viewed as real (``torch.view_as_real``), and each received
buffer is checked against what was sent. The cases:

* ``even``: equal splits to every rank;
* ``uneven``: the whole buffer to the next rank, zero elements to the others;
* ``uneven_sizes``: the same with a buffer size that differs by rank;
* ``one_way``: rank 0 sends to rank 1 only (rank 1 sends nothing, rank 0
  receives nothing);
* ``empty``: no rank sends anything.

All cases run in one world; if that world fails (gloo can abort the
process on CUDA tensors, as it does on send/recv), each case runs again in
a world of its own, so that the one at fault is named. Prints one JSON
line: torch's version, the card (``nvidia-smi``'s name and power limit) and,
per device, each case's outcome: "ok", "wrong values" or the first line of
its error.
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

CASES = ("even", "uneven", "uneven_sizes", "one_way", "empty")
DTYPES = ("float32", "complex64")


def _plan(case: str, rank: int, n: int):
    """(this rank's send sizes per peer, its receive sizes per peer) in
    elements of the float32 buffer."""
    if case == "even":
        return [8] * n, [8] * n
    if case in ("uneven", "uneven_sizes"):
        size = (lambda r: 8 + 4 * r) if case == "uneven_sizes" else (lambda r: 8)
        send = [0] * n
        recv = [0] * n
        send[(rank + 1) % n] = size(rank)
        recv[(rank - 1) % n] = size((rank - 1) % n)
        return send, recv
    if case == "one_way":
        send, recv = [0] * n, [0] * n
        if rank == 0:
            send[1] = 8
        if rank == 1:
            recv[0] = 8
        return send, recv
    return [0] * n, [0] * n


def _payload(src: int, dst: int, count: int, dtype: str, device) -> torch.Tensor:
    """The float32 elements rank ``src`` sends rank ``dst``: distinct values
    per pair (a complex64 tensor's real view for ``complex64``)."""
    if dtype == "complex64":
        z = torch.complex(torch.arange(count // 2, dtype=torch.float32) + 100.0 * src,
                          -torch.arange(count // 2, dtype=torch.float32) - 10.0 * dst)
        return torch.view_as_real(z.to(device)).reshape(-1)
    return (torch.arange(count, dtype=torch.float32) + 100.0 * src + 10.0 * dst).to(device)


def _run(case: str, dtype: str, device) -> bool:
    n, rank = dist.get_world_size(), dist.get_rank()
    send, recv = _plan(case, rank, n)
    parts = [_payload(rank, d, c, dtype, device) for d, c in enumerate(send)]
    src = torch.cat(parts) if sum(send) else torch.empty(0, device=device)
    out = torch.full((sum(recv),), float("nan"), device=device)
    dist.all_to_all_single(out, src, output_split_sizes=recv, input_split_sizes=send)
    if device.type == "cuda":
        torch.cuda.synchronize()
    want = [_payload(s, rank, c, dtype, device) for s, c in enumerate(recv)]
    want = torch.cat(want) if sum(recv) else torch.empty(0, device=device)
    return bool(torch.equal(out, want))


def probe_rank(rank: int, cases, device_name: str) -> dict:
    device = torch.device(device_name)
    out = {}
    for case in cases:
        for dtype in DTYPES:
            try:
                out[f"{case}/{dtype}"] = "ok" if _run(case, dtype, device) else "wrong values"
            except RuntimeError as e:
                out[f"{case}/{dtype}"] = f"{type(e).__name__}: {str(e).splitlines()[0][:240]}"
    return out


def _merge(ranks) -> dict:
    """Each case's outcome: "ok" only where every rank says so."""
    keys = ranks[0].keys()
    return {k: next((r[k] for r in ranks if r[k] != "ok"), "ok") for k in keys}


def probe(device_name: str) -> dict:
    mesh = parallel.make_mesh(devices=[device_name] * 2)
    try:
        return _merge(parallel.launch(probe_rank, mesh, CASES, device_name, timeout=120.0))
    except (RuntimeError, TimeoutError) as e:
        first = str(e).splitlines()[0][:240]
    out = {"all_in_one_world": f"world failed: {first}"}
    for case in CASES:
        try:
            out.update(_merge(parallel.launch(probe_rank, mesh, (case,), device_name, timeout=120.0)))
        except (RuntimeError, TimeoutError) as e:
            out.update({f"{case}/{d}": f"world failed: {str(e).splitlines()[0][:240]}" for d in DTYPES})
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
                      "gloo_all_to_all_single": {d: probe(d) for d in devices}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
