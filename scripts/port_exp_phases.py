"""Where the time of a hand-written conv kernel goes, by leaving out one
phase of it at a time, on one CUDA card.

Builds copies of ``kernels/csrc`` into the port's git-ignored build
directory, each with one phase of the kernel removed (or, where named so,
one design choice changed) by a textual patch of its source, and times the
patched entry point through the same launch path as the wrapper, beside
the intact one. A variant that removes a phase computes a wrong result;
only its time is read. The difference from the intact kernel bounds what
the phase costs where nothing overlaps it. ``--kernel``:

* ``tail``: ``fused_conv_tail`` in bf16, (B, 64, 128, 128) -> (B, 2, 128,
  128): ``no_products_conv8_conv9`` (the products of every ``tc_conv_ss``
  layer; their epilogues still run, on zero sums), ``no_conv10``,
  ``no_input_load``, ``no_conv9_weights``;
* ``head``: ``fused_encoder_head`` in bf16, (B, 1, 128, 128) -> (B, 64, 64,
  64): ``no_products_conv1_2``, ``no_conv1_1``,
  ``no_pool``, ``no_pool_stores`` (the pool's global stores only),
  ``no_input_load`` (the input's loads, prefetched a tile ahead);
* ``ring``: ``border_lines`` in fp32 at (B, 64, 128, 128), k (64, 64, 3,
  3): ``no_products``, ``no_line_values`` (the line values' loads and
  their scatter into the taps' rows), ``no_tap_fold`` (the prologue
  kernel), ``row_lines_only`` and ``column_lines_only`` (the blocks of one
  orientation return at once); and variants of the design:
  ``k_unrolled_by_8`` (the product loop over a chunk's 48 K rows unrolled
  8 times instead of fully), ``chunks_of_4_channels`` (K staged 24 rows at
  a time: half the shared memory), ``carveout_max_shared`` (the SM's
  shared memory at its largest, its L1 cache at its least).

Every kernel is also timed as a run of 20 launches between two events
(``*_x20``, per launch), which hides the wrapper's host time behind the
card's work, and the intact kernel is held against its plain version
(budget 1e-2 of max in bf16, 1e-5 in fp32). CUDA-event medians
(``utils/bench.py``); prints one JSON line with the card's name and power
limit.

    python scripts/port_exp_phases.py --kernel tail|head|ring [--batch 256] [--reps 7]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from style_transfer_based_holographic_imaging_tpu_torch.kernels import (  # noqa: E402
    _build,
    conv_stack,
    reflect_border,
)
from style_transfer_based_holographic_imaging_tpu_torch.utils.bench import (  # noqa: E402
    median_ms,
    seeded_stack,
)

PRODUCTS = "          wgmma_ss<PIX>(acc, da + 2 * k, db + 2 * k);\n"
RING_LAUNCH = "  ring_gemm_kernel<T><<<(unsigned)blocks, THREADS, SMEM_BYTES, stream>>>(\n"
RING_LOAD_LINES = "  auto load_lines = [&](int c0) {\n"
RING_PREFETCH = ("    for (int cc = 0; cc < KC && pm.ok; ++cc) {{\n"
                 "      const int c = c0 + {0} * KC + cc;\n"
                 "      if (c < C) asm volatile(\"prefetch.global.L2 [%0];\" ::\"l\"(xm + (size_t)c * plane));\n"
                 "    }}\n")
RING_K_LOOP = "#pragma unroll\n    for (int k = 0; k < BK; ++k) {\n"
RING_ORIENTATION = "  const bool is_row = nb < both ? nb % 2 == 0 : nb_rows > nb_cols;\n"
# kernel -> (source, the header or source patched, variants: name -> [(old, new)])
VARIANTS = {
    "tail": ("conv_stack", "conv_tile.cuh", {
        "no_products_conv8_conv9": [(PRODUCTS, "")],
        "no_conv10": [("  tc_conv_last<VALID_H>(tb, ws10, p.np10, bs + p.np8 + p.np9, O10, to, g, H, W, "
                       "g_y0, g_h);\n", "")],
        "no_input_load": [("  tc_load_tile<VALID_H>(xb, C, H, W, tx);\n", "")],
        "no_conv9_weights": [("  tc_stage_weights(w9, p.cp8, p.np9, ws);\n", "")],
    }),
    "head": ("conv_stack", "conv_tile.cuh", {
        "no_products_conv1_2": [(PRODUCTS, "")],
        "no_conv1_1": [("  head_conv1<ROWS + 2, COLS + 2>(xs, C, w1s, bs, ta, H, W);\n", "")],
        "no_pool": [("  head_pool<ROWS, COLS>(to, O2, H, W, g);\n", "")],
        "no_pool_stores": [("        asm volatile(\"st.global.v4.b32 [%0], {%1, %2, %3, %4};\\n\" ::\"l\"(dst), ",
                            "        if (w[0] == 0x7fc17fc1u && w[1] == w[2] && w[3] == w[0]) dst[0] = 0;\n"
                            "        if (false) asm volatile(\"st.global.v4.b32 [%0], {%1, %2, %3, %4};\\n\" ::\"l\"(dst), ")],
        "no_input_load": [("    head_put<ROWS + 4, COLS + 4>(pre, xs);\n", "")],
    }),
    "ring": ("reflect_border", "reflect_border.cu", {
        "no_products": [("        for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);\n",
                         "        for (int v = 0; v < 8; ++v) {}\n")],
        "no_line_values": [("  auto store_lines = [&](float* dst) {\n",
                            "  auto store_lines = [&](float* dst) {\n    return;\n")],
        "no_tap_fold": [("  err = launch_taps<T>(k, taps, C, O, stream);\n", "  err = 0;\n")],
        "k_unrolled_by_8": [(RING_K_LOOP, RING_K_LOOP.replace("unroll", "unroll 8"))],
        "chunks_of_4_channels": [("constexpr int KC = 8;", "constexpr int KC = 4;")],
        "l2_prefetch_a_chunk_ahead": [(RING_LOAD_LINES, RING_LOAD_LINES + RING_PREFETCH.format(1))],
        "l2_prefetch_two_chunks_ahead": [(RING_LOAD_LINES, RING_LOAD_LINES + RING_PREFETCH.format(2))],
        "carveout_max_shared": [(RING_LAUNCH, "  cudaFuncSetAttribute(ring_gemm_kernel<T>, "
                                 "cudaFuncAttributePreferredSharedMemoryCarveout, "
                                 "cudaSharedmemCarveoutMaxShared);\n" + RING_LAUNCH)],
        "row_lines_only": [(RING_ORIENTATION, RING_ORIENTATION + "  if (!is_row) return;\n")],
        "column_lines_only": [(RING_ORIENTATION, RING_ORIENTATION + "  if (is_row) return;\n")],
    }),
}


def build_variants(kernel: str) -> dict[str, str]:
    """One nvcc per variant, all started together once every patch has
    applied; name -> library path. A failed build stops the others."""
    source, patched, variants = VARIANTS[kernel]
    original = open(os.path.join(_build.CSRC_DIR, patched)).read()
    texts = {}
    for name, patches in variants.items():
        text = original
        for old, new in patches:
            if old not in text:
                raise SystemExit(f"variant {name}: its patch no longer applies to {patched}")
            text = text.replace(old, new)
        texts[name] = text
    procs, libs = {}, {}
    try:
        for name, text in texts.items():
            d = os.path.join(_build.BUILD_DIR, f"phases_{kernel}_{name}")
            shutil.rmtree(d, ignore_errors=True)
            shutil.copytree(_build.CSRC_DIR, d)
            with open(os.path.join(d, patched), "w") as f:
                f.write(text)
            libs[name] = os.path.join(d, f"lib{source}.so")
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", libs[name], os.path.join(d, f"{source}.cu")]
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


def callers(kernel: str, batch: int, dev):
    """(intact call, lib -> call of that library's entry point, rel err of
    the intact kernel against the plain version, its budget)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    if kernel in ("tail", "head"):
        head = kernel == "head"
        widths = (64, 64) if head else (64, 64, 2)
        a = seeded_stack(batch, torch.bfloat16, 1 if head else 64, widths, 2, dev)
        layers = tuple((a[j], a[j + 1]) for j in range(1, len(a), 2))
        run = conv_stack.fused_encoder_head if head else conv_stack.fused_conv_tail
        plain = conv_stack.encoder_head_plain if head else conv_stack.conv_tail_plain
        ref = plain(a[0][:4], *a[1:]).float()
        rel = float((run(*a)[:4].float() - ref).abs().max() / ref.abs().max())
        out = torch.empty_like(run(*a))

        def lib_call(lib):
            fn = lib.conv_head if head else lib.conv_tail
            fn.argtypes = [i, p, i, i, i, i] + [p, p, i] * len(layers) + [p, p]
            fn.restype = ctypes.c_int
            tiles = conv_stack.HEAD_TC_TILES if head else conv_stack.TC_N_TILES
            counts = {kernel: 0}
            return lambda: conv_stack.launch(counts, kernel, fn, a[0], layers, out, tc_tiles=tiles)

        return (lambda: run(*a)), lib_call, rel, 1e-2
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(batch, 64, 128, 128, generator=g, device=dev)
    k = torch.randn(64, 64, 3, 3, generator=g, device=dev) * (2.0 / 576) ** 0.5
    got, ref = reflect_border.border_lines(x, k), reflect_border.border_lines_plain(x, k)
    rel = max(float((u - v).abs().max() / v.abs().max()) for u, v in zip(got, ref))
    rows, cols = torch.empty_like(got[0]), torch.empty_like(got[1])
    taps = reflect_border._taps_buffer(k)

    def lib_call(lib):
        lib.border_lines.argtypes = [i, p, p, p, p, p, i, i, i, i, i, p]
        lib.border_lines.restype = ctypes.c_int
        stream = torch.cuda.current_stream(dev).cuda_stream
        b, c, h, w = x.shape
        return lambda: _build.check_status(lib.border_lines(
            0, x.data_ptr(), k.data_ptr(), taps.data_ptr(), rows.data_ptr(), cols.data_ptr(),
            b, c, h, w, k.shape[0], stream), "border_lines")

    return (lambda: reflect_border.border_lines(x, k)), lib_call, rel, 1e-5


def times20(fn):
    def run():
        for _ in range(20):
            fn()
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(VARIANTS), default="tail")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the kernel on a card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    libs = build_variants(args.kernel)
    dev = torch.device("cuda")
    intact, lib_call, rel, tol = callers(args.kernel, args.batch, dev)
    ms = {"intact": median_ms(intact, reps=args.reps),
          "intact_x20": median_ms(times20(intact), reps=args.reps) / 20}
    for name, path in libs.items():
        call = lib_call(ctypes.CDLL(path))
        ms[name] = median_ms(call, reps=args.reps)
        ms[f"{name}_x20"] = median_ms(times20(call), reps=args.reps) / 20
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi, "kernel": args.kernel,
        "batch": args.batch, "ms": ms,
        "saved_ms": {k: ms["intact"] - v for k, v in ms.items() if not k.startswith("intact")
                     and not k.endswith("_x20")},
        "saved_ms_x20": {k[:-4]: ms["intact_x20"] - v for k, v in ms.items()
                         if k.endswith("_x20") and not k.startswith("intact")},
        "intact_rel_err_vs_plain": rel, "tol": tol,
    }))
    return 0 if rel < tol else 1


if __name__ == "__main__":
    sys.exit(main())
