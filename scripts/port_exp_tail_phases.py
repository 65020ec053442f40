"""Where the time of the tensor-core decoder tail goes, by leaving out one
phase of its tile at a time, on one CUDA card.

Builds copies of ``kernels/csrc/conv_stack.cu`` (with ``conv_tile.cuh``)
into the port's git-ignored build directory, each with one phase of
``tc_tail_tile`` removed by a textual patch of the header, and times
``conv_tail`` in bf16 at B = 256, 128^2, 64 -> 64 -> 64 -> 2 through the
same launch path as ``fused_conv_tail``. A variant computes a wrong tail;
only its time is read. The difference from the intact kernel bounds what
the phase costs where nothing overlaps it:

* ``no_products_conv8_conv9``: the m64n112k16 products of conv8 and conv9
  (their epilogues still run, on zero sums);
* ``no_conv10``: the whole of conv10 (products and stores);
* ``no_input_load``: the input tile's NCHW -> channels-last load;
* ``no_conv9_weights``: the staging of conv9's weights.

The intact kernel is also held against ``conv_tail_plain`` (bf16 budget
1e-2 of max). CUDA-event medians (``utils/bench.py``); prints one JSON line
with the card's name and power limit.

    python scripts/port_exp_tail_phases.py [--batch 256] [--reps 7]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from style_transfer_based_holographic_imaging_tpu_torch.kernels import _build, conv_stack  # noqa: E402
from style_transfer_based_holographic_imaging_tpu_torch.utils.bench import (  # noqa: E402
    median_ms,
    seeded_stack,
)

TAIL_WIDTHS = (64, 64, 2)
PRODUCTS = "          wgmma_ss_n112(acc, da + 2 * k, db + 2 * k);\n"
CONV10 = "  tc_conv_last<VALID_H>(tb, ws10, p.np10, bs + p.np8 + p.np9, O10, to, g, H, W, g_y0, g_h);\n"
LOAD = "  tc_load_tile<VALID_H>(xb, C, H, W, tx);\n"
W9 = "  tc_stage_weights(w9, p.cp8, p.np9, ws);\n"
VARIANTS = {
    "no_products_conv8_conv9": [(PRODUCTS, "")],
    "no_conv10": [(CONV10, "")],
    "no_input_load": [(LOAD, "")],
    "no_conv9_weights": [(W9, "")],
}


def build_variants() -> dict[str, str]:
    """One nvcc per variant, all started together once every patch has
    applied; name -> library path. A failed build stops the others."""
    header = open(os.path.join(_build.CSRC_DIR, "conv_tile.cuh")).read()
    source = open(os.path.join(_build.CSRC_DIR, "conv_stack.cu")).read()
    texts = {}
    for name, patches in VARIANTS.items():
        text = header
        for old, new in patches:
            if old not in text:
                raise SystemExit(f"variant {name}: its patch no longer applies to conv_tile.cuh")
            text = text.replace(old, new)
        texts[name] = text
    procs, libs = {}, {}
    try:
        for name, text in texts.items():
            d = os.path.join(_build.BUILD_DIR, f"phases_{name}")
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "conv_tile.cuh"), "w") as f:
                f.write(text)
            with open(os.path.join(d, "conv_stack.cu"), "w") as f:
                f.write(source)
            libs[name] = os.path.join(d, "libconv_stack.so")
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", libs[name], os.path.join(d, "conv_stack.cu")]
            procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for name, proc in procs.items():
            out = proc.communicate()[0].decode()
            if proc.returncode != 0:
                raise SystemExit(f"nvcc failed on variant {name}:\n{out[-4000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the kernel on a card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    libs = build_variants()
    a = seeded_stack(args.batch, torch.bfloat16, 64, TAIL_WIDTHS, 2, torch.device("cuda"))
    layers = ((a[1], a[2]), (a[3], a[4]), (a[5], a[6]))
    plain = conv_stack.conv_tail_plain(a[0][:4], *a[1:]).float()
    ms = {"intact": median_ms(lambda: conv_stack.fused_conv_tail(*a), reps=args.reps)}
    rel = float((conv_stack.fused_conv_tail(*a)[:4].float() - plain).abs().max() / plain.abs().max())
    out = torch.empty(args.batch, 2, 128, 128, dtype=torch.bfloat16, device="cuda")
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        lib.conv_tail.argtypes = [i, p, i, i, i, i] + [p, p, i] * 3 + [p, p]
        lib.conv_tail.restype = ctypes.c_int
        counts = {name: 0}
        ms[name] = median_ms(lambda: conv_stack.launch(counts, name, lib.conv_tail, a[0], layers, out,
                                                       tensor_cores=True), reps=args.reps)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "batch": args.batch,
        "ms": ms, "saved_ms": {k: ms["intact"] - v for k, v in ms.items() if k != "intact"},
        "intact_rel_err_vs_plain": rel, "tol": 1e-2,
    }))
    return 0 if rel < 1e-2 else 1


if __name__ == "__main__":
    sys.exit(main())
