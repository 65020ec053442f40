"""Reproduce, with torch and numpy alone, a wrong first multi-threaded op.

On some CPU hosts the first multi-threaded elementwise op after a large
``normal_`` and ``copy_`` (what building a net and loading its state dict
does) returns one worker's chunk with about 2**-12 relative error. This
script runs that sequence in fresh processes: fill tensors of the ``fast``
release's shapes with ``normal_``, ``copy_`` its weights in, then
``torch.sqrt`` of golden batch 10's first four holograms, three times, each
against numpy's sqrt. It prints one JSON line: by mode, the processes run
and those whose first ``sqrt`` was wrong, with the worst relative error.

Modes: ``cold`` (the sequence as described), ``one_thread``
(``torch.set_num_threads(1)`` first), ``warm`` (one multi-threaded
``sqrt`` before the sequence) and ``avx2`` (``cold`` with
``ATEN_CPU_CAPABILITY=avx2``).

    python scripts/port_repro_cpu_threads.py --runs 30
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "checkpoints", "fast", "torch_weights.npz")
MODES = ("cold", "one_thread", "warm", "avx2")


def _holograms() -> np.ndarray:
    sys.path.insert(0, REPO)
    from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite

    return np.ascontiguousarray(load_golden_suite().content_holo[10][:4])


def child(mode: str, holo_path: str) -> None:
    """One process: the sequence, then three sqrts against numpy's."""
    import torch

    if mode == "one_thread":
        torch.set_num_threads(1)
    if mode == "warm":
        w = np.random.default_rng(0).random(1 << 16, dtype=np.float32) + 0.5
        torch.sqrt(torch.from_numpy(w))
    with np.load(WEIGHTS) as z:
        state = {k: torch.from_numpy(z[k]) for k in z.files}
    with torch.no_grad():
        for v in state.values():
            torch.nn.init.normal_(torch.empty_like(v)).copy_(v)
    holo = np.load(holo_path)
    ref = torch.from_numpy(np.sqrt(holo))
    wrong, worst = [], 0.0
    for _ in range(3):
        x = torch.sqrt(torch.as_tensor(holo, dtype=torch.float32))
        rel = ((x - ref) / ref).abs()
        wrong.append(int((rel > 1e-6).sum()))
        worst = max(worst, float(rel.max()))
    print(json.dumps({"wrong": wrong, "worst_rel": worst}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=30, help="fresh processes a mode")
    ap.add_argument("--modes", nargs="+", default=list(MODES), choices=MODES)
    ap.add_argument("--child", choices=MODES, help=argparse.SUPPRESS)
    ap.add_argument("--holo", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.holo)
        return 0
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        holo_path = os.path.join(tmp, "holo.npy")
        np.save(holo_path, _holograms())
        result = {}
        for mode in args.modes:
            env = dict(os.environ)
            if mode == "avx2":
                env["ATEN_CPU_CAPABILITY"] = "avx2"
            first_wrong, later_wrong, worst = 0, 0, 0.0
            for _ in range(args.runs):
                out = subprocess.run(
                    [sys.executable, __file__, "--child", mode, "--holo", holo_path],
                    env=env, capture_output=True, text=True, check=True)
                r = json.loads(out.stdout.strip().splitlines()[-1])
                first_wrong += r["wrong"][0] > 0
                later_wrong += any(r["wrong"][1:])
                worst = max(worst, r["worst_rel"])
            result[mode] = {"processes": args.runs, "first_sqrt_wrong": first_wrong,
                            "later_sqrt_wrong": later_wrong, "worst_rel_err": worst}
    import torch

    print(json.dumps({"torch": torch.__version__, "cpus": os.cpu_count(),
                      "threads": torch.get_num_threads(), "modes": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
