"""Check and time the port's ASM propagator kernels on one CUDA card.

Builds ``kernels/csrc/asm_propagate.cu`` alone, prints the compiler's
``-Xptxas -v`` lines (registers, shared memory, spills of each kernel) and
the ``nvcc`` seconds, then holds ``asm_const`` and ``asm_dynamic`` against
their plain versions in every precision mode, smallest shape first, each
call synchronised and printed before the next (a fault names its shape).
Tolerance on max|err| / max|plain|: 1e-5 highest, 1e-4 high, 2e-2 bf16, the
JAX package's budgets. With ``--time``, CUDA-event medians at the last
``--shape`` of each kernel per mode beside its plain version and the
``torch.fft`` composition; with ``--profile``, each launched kernel's
device time a call from a ``torch.profiler`` trace. Inputs: uniform [0, 1) re/im planes from
``torch.Generator`` seed 0; per-sample distances over +-0.8 mm.

Prints one JSON line per check, then one with the times; exits 1 on a
disagreement, 2 without a card, 3 when the ``--watchdog`` seconds run out.

    python scripts/port_exp_asm.py [--shape 1,16,16 --shape 256,128,128] [--time] [--profile]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from style_transfer_based_holographic_imaging_tpu_torch.kernels import _build, asm_cuda  # noqa: E402
from style_transfer_based_holographic_imaging_tpu_torch.ops.asm import propagate_torch  # noqa: E402
from style_transfer_based_holographic_imaging_tpu_torch.utils.bench import median_ms  # noqa: E402

KW = dict(wavelength=532e-9, pixel_size=1.5e-6)
BUDGETS = {"highest": 1e-5, "high": 1e-4, "bf16": 2e-2}
SHAPES = ("1,16,16", "2,48,64", "2,48,80", "2,40,56", "2,18,30", "5,128,128", "256,128,128")
REFOCUS_M = -2e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def planes(b, h, w, device):
    g = torch.Generator().manual_seed(0)
    return (torch.rand(b, h, w, generator=g).to(device), torch.rand(b, h, w, generator=g).to(device))


def rel(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


def profile(shape, dev, calls: int = 10) -> dict:
    """Device microseconds a call of each kernel the wrappers launch, by
    wrapper and precision mode, from a ``torch.profiler`` trace of ``calls``
    calls after a warm-up."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    b, h, w = shape
    xre, xim = planes(b, h, w, dev)
    dist = torch.linspace(-8e-4, 8e-4, b, device=dev)
    out = {}
    for name, run, d in (("asm_const", asm_cuda.asm_const, REFOCUS_M),
                         ("asm_dynamic", asm_cuda.asm_dynamic, dist)):
        for prec in BUDGETS:
            run(xre, xim, d, precision=prec, **KW)
            torch.cuda.synchronize()
            with trace(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    run(xre, xim, d, precision=prec, **KW)
                torch.cuda.synchronize()
            rows = {}
            for e in prof.key_averages():
                us = getattr(e, "self_device_time_total", None)
                if us is None:
                    us = getattr(e, "self_cuda_time_total", 0.0)
                if us > 0:
                    key = e.key.replace("(anonymous namespace)::", "").split("(")[0]
                    rows[key.replace("void ", "")] = round(us / calls, 3)
            out[f"{name}/{prec}"] = rows
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", action="append", help="B,H,W (repeatable)")
    ap.add_argument("--time", action="store_true", help="time at the last shape")
    ap.add_argument("--profile", action="store_true",
                    help="device time of each launched kernel at the last shape (torch.profiler)")
    ap.add_argument("--watchdog", type=float, default=300.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: the kernels run on a card", file=sys.stderr)
        return 2
    timer = threading.Timer(args.watchdog, lambda: (print("watchdog", file=sys.stderr, flush=True),
                                                    os._exit(3)))
    timer.daemon = True
    timer.start()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30).stdout.strip()
    emit({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    _build.remove_stale()
    seconds = _build.build("asm_propagate")
    emit({"nvcc_seconds": seconds["asm_propagate"],
          "ptxas": _build.ptxas_lines("asm_propagate")})
    dev = torch.device("cuda")
    shapes = [tuple(int(v) for v in s.split(",")) for s in (args.shape or SHAPES)]
    ok = True
    for b, h, w in shapes:
        xre, xim = planes(b, h, w, dev)
        dist = torch.linspace(-8e-4, 8e-4, b, device=dev)
        for prec, tol in BUDGETS.items():
            for name, run, plain, d in (
                ("asm_const", asm_cuda.asm_const, asm_cuda.asm_const_plain, REFOCUS_M),
                ("asm_dynamic", asm_cuda.asm_dynamic, asm_cuda.asm_dynamic_plain, dist),
            ):
                y = torch.complex(*run(xre, xim, d, precision=prec, **KW))
                torch.cuda.synchronize()
                p = torch.complex(*plain(xre, xim, d, precision=prec, **KW))
                row = {"kernel": name, "shape": [b, h, w], "precision": prec, "tol": tol,
                       "finite": bool(torch.isfinite(y).all()),
                       "max_abs_err": float((y - p).abs().max()), "rel_err_vs_plain": rel(y, p)}
                row["ok"] = row["finite"] and row["rel_err_vs_plain"] < tol
                ok = ok and row["ok"]
                emit(row)
    if args.profile and ok:
        emit({"profile_us_per_call": profile(shapes[-1], dev)})
    if args.time and ok:
        b, h, w = shapes[-1]
        xre, xim = planes(b, h, w, dev)
        field = torch.complex(xre, xim)
        dist = torch.linspace(-8e-4, 8e-4, b, device=dev)
        times = {"shape": [b, h, w]}
        for name, run, plain, d, fft_d in (
            ("asm_const", asm_cuda.asm_const, asm_cuda.asm_const_plain, REFOCUS_M, REFOCUS_M),
            ("asm_dynamic", asm_cuda.asm_dynamic, asm_cuda.asm_dynamic_plain, dist,
             dist.reshape(b, 1, 1)),
        ):
            times[name] = {p: median_ms(lambda: run(xre, xim, d, precision=p, **KW)) for p in BUDGETS}
            times[name]["plain_high"] = median_ms(lambda: plain(xre, xim, d, precision="high", **KW), reps=5)
            times[name]["torch_fft"] = median_ms(lambda: propagate_torch(field, fft_d, **KW))
        emit({"ms": times})
    timer.cancel()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
