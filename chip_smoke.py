#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card, and check it.

    python3 chip_smoke.py

Phases, each under its own wall-clock budget (a phase that overruns prints a
line naming it and ends the run with exit code 3; nothing hangs):

1. ``device``  — a CUDA card must be present (else exit 2); prints the card's
   name and power limit (``nvidia-smi``) and the TF32 flags.
2. ``build``   — the script removes stale build files and starts one
   ``nvcc`` for each of the four kernel sources, all together, before it
   imports torch (``kernels/_build.py`` imports no torch): the ASM source
   on one thread, the other three on another, and the host compiler on the
   zstd decoder (``interop/csrc/zstd_decode.cc``) on a third. The phase
   waits for the ASM library and loads it with ``ctypes``, and for the
   decoder; prints their seconds and the ASM source's ``-Xptxas -v``
   lines (registers, shared memory, spills). The three
   others compile on while phases 3-5, which launch only the ASM kernels,
   run.
3. ``kernels`` — the ASM kernels against their plain PyTorch version and
   the ``torch.fft`` composition, at B = 5 and 256, in
   every precision mode, with per-sample distances spread over the suite's
   range for ``asm_dynamic``, and against the plain version alone at the
   ragged shapes ``ODD_SHAPES``; tolerance on max|err| / max|ref|: 1e-5
   (highest), 1e-4 (high), 2e-2 (bf16), the JAX package's budgets.
4. ``slice``   — the flagship-width net (width 1.0) on weights drawn from
   ``torch.Generator`` seed 0: the whole 20 x 5 golden suite through
   ``evaluate_golden_suite`` and one ``retrieval_step`` with per-sample style
   distances, with the launch counts reset just before and read just after;
   both ASM kernels must have launched. Then one golden batch on the card
   against the same port on the CPU.
5. ``refine``  — physics refinement, whose steps differentiate the
   propagator: the gradients of the ops ``asm_const`` and ``asm_dynamic``
   (the kernels forward, the composition's adjoint in ``torch.fft``
   backward) against
   ``propagate_torch`` autograd at B = 5 and 256, in ``high`` and
   ``highest``, rtol 1e-3 of the largest gradient; ``physics_refine`` on
   golden batch 10 from its GT phase plus 0.3 rad of noise (numpy seed 0) at
   the true distances, 100 steps, on the card against the same call on the
   CPU (PSNR within 0.05 dB); ``evaluate_golden_suite(refine_steps=100)`` on
   the seeded net with the launch counts reset just before and read just
   after (``asm_dynamic`` must have launched 20 x 101 times).
5b. ``conv_kernels`` — waits for the other three libraries and loads them;
   prints their ``nvcc`` seconds and ``-Xptxas -v`` lines. Then the conv
   stacks at flagship shapes and the border ring at ``RING_LAYERS`` (three
   of the net's layers, one odd H, short lines that share a block, output
   channels off 64), at B = 5 and 256, in fp32 and bf16, the tail at the
   ragged shapes ``TAIL_ODD_SHAPES``, the head at ``HEAD_ODD_SHAPES`` (the
   releases' widths, H and W off its tile), both also at 80 channels, past
   the tensor-core bodies' 64 (bf16 there runs the SIMT body); tolerance
   1e-5 in fp32
   (summation order) and 1e-2 in bf16 (a value that the other summation
   order puts on a bf16 rounding boundary rounds the other way, 2^-8
   relative, and carries into the next layer).
   The world of phase 19 is spawned after this phase.
6. ``quant``   — the int8 serving path on the same net: int8 scales
   calibrated on the golden suite, then the suite through
   ``evaluate_golden_suite(quant_scales=..., dtype=bf16)`` with the fused
   stacks on, the counts reset just before and read just after (both stack
   kernels must have launched, every launch on the tensor cores). Then one
   golden batch against the same
   port on the CPU: every int8 conv, stack and transposed conv of the
   card's run again on the CPU from the same inputs, where the two runs
   part (differing int8 steps, call by call), what one int8 step moves, the
   outputs, and the same path without int8 convs. Last, the suite once more
   with the stacks off.
7. ``reflect`` — ``retrieval_step`` on one golden batch with the reflect
   backend ``cuda`` (the border ring must launch once for each of the net's
   20 reflect convs, whose shapes the phase records), against the
   ``matpad`` backend on the card.
8. ``halo``    — the halo row-block decoder tail, the path of
   ``scripts/port_exp_halo_conv.py``: ``halo_conv_tail`` and
   ``halo_conv_tail_static`` at B = 256, 128^2 x 64 -> 2, bf16, bh 30 and
   60, with the halo counts reset just before and read just after (both
   kernels must have launched). Then both kernels against
   ``halo_conv_tail_plain`` at B = 5 and 256, fp32 and bf16, bh 30 and 60,
   C = 64 (flagship) and 16 (``ultra``'s width), and at the ragged shapes
   ``HALO_ODD_SHAPES``, and their interior rows against ``fused_conv_tail``
   on the same input (the same function there, the same tile body): equal
   bit for bit in bf16, within the conv tolerance in fp32. Then both
   kernels and ``conv_tail_reference`` on the card against the port's CPU
   versions on the same inputs (the edge rows' strips take cuDNN's convs on
   the card), bf16 edge rows within four ulps of max|ref|.
9. ``timing``  — (last, when no other process of the run is left) CUDA-event
   medians at B = 256 of each kernel, its plain
   version and its library call in fp32 and bf16, the ring at each of the
   20 reflect convs of the step (and their sum beside its bound), and of
   the whole
   ``retrieval_step`` (holograms/s): fp32, int8 with the stacks on and with
   them off (with the stages of each), fp32 with the ring; the halo phase's
   rows (the script's, ``scripts/port_exp_halo_conv.py``); one refine at
   B = 256, 128^2, 100 steps timed with CUDA events, beside the same refine
   through ``torch.fft`` alone (``asm_backend='torch'``), and split into the
   forward kernel, the adjoint backward and the rest.

10. ``golden`` — the ``fast`` release's own weights
   (``checkpoints/fast/torch_weights.npz``; a missing file fails the run)
   over the whole 20 x 5 suite on the card, with the launch counts reset
   just before and read just after: fp32, every batch within 0.3 dB of
   ``golden_metrics.json`` (the release gate's rule) and within 0.005 dB
   (this card's fp32; the bf16 net is 0.013 dB off on the mean), and every
   distance within 3 µm; int8 in bf16 with
   the stacks off, mean PSNR within 0.05 dB and R² within 1e-4 of
   ``quant_golden_metrics.json``; int8 with the stacks on (no record: printed
   beside the stacks-off run; every stack launch on the tensor cores);
   refined, 100 steps, mean and held-out PSNR within 0.05 dB of the
   ``refined_*`` records; the fp net in bf16, held to the JAX package's
   ``bf16_golden_metrics.json`` with the int8 rule. A miss prints every
   reading and fails the phase.
10b. ``release`` — the flagship release (``checkpoints/release``, width
   1.0) read by the port's own orbax reader (``interop/orbax_read.py``:
   OCDBT, zarr and the C++ zstd decoder built in phase 2); its seconds and
   the bytes it read. ``cli._load_params`` with no
   ``--checkpoint`` must give the same state dict. Then the ``golden``
   phase's paths and rules on the flagship with ``checkpoints/
   style_vector.npz``, ``quant_scales.json``, ``golden_metrics.json`` and
   ``quant_golden_metrics.json``; it has no bf16 record, so its bf16 mean
   is printed and not held. ``asm_const`` 20 launches a path (100),
   ``asm_dynamic`` 2,020, the head and tail 20 each with the stacks on.
   Then the two domain releases, ``checkpoints/rbc_release`` and
   ``bead_release`` (``bead``'s, saved on a TPU, with no target), read by
   the same reader for phases 11, 14 and 15.
10c. ``narrow_releases`` — the narrow MNIST releases ``balanced``,
   ``turbo`` and ``ultra`` (widths 0.75, 0.375, 0.25) read by the same
   reader (seconds and bytes), each over the whole suite through the
   ``golden`` phase's fp32 and int8 paths (``run_golden``): fp32 every
   batch within 0.3 dB of ``golden_metrics.json``, and within 0.005 dB and
   every distance within 3 µm of the port's CPU reading
   (``checkpoints/port_cpu_golden_readings.json``), since both packages
   miss the records' distances alike (ROADMAP C.10); int8 with the stacks
   off within 0.05 dB and R² 1e-4 of ``quant_golden_metrics.json``,
   ``ultra``'s R² against the port's CPU reading (ROADMAP C.2); the stacks
   on printed, the head and tail 20 launches each, on the tensor cores.
   Then the refine with the distance (``eval --refine N
   --refine-distance``) at the records' 240 steps on the first 3 golden
   batches of ``balanced`` and ``turbo``, batch by batch: the mean within
   0.05 dB and R² within 1e-4 of the port's CPU reading of those batches at
   2 torch threads, the 20-batch records printed, ``asm_const`` 3 and
   ``asm_dynamic`` 3 x (120 + 240 + 1) launches. Last, ``cli eval
   --checkpoint checkpoints/turbo/release --refine 10 --refine-distance``
   in process (the whole suite: the CLI scores no fewer batches) against
   the direct ``evaluate_golden_suite`` call with the same arguments, each
   batch within 2e-4 dB and each distance within 0.05 µm, 20 + 420 ASM
   launches. Every count is reset just before its path and read just
   after; a propagation through ``torch.fft`` on these paths fails the
   phase.
11. ``serve``  — ``RetrievalService`` on the ``fast`` weights (bf16, batch
   32) behind ``serve_forever`` on 127.0.0.1, port 0, in a daemon thread:
   requests of B = 1, 5 (a golden batch) and 37 (chunked and padded) through
   ``retrieve_remote``, each answer equal bit for bit to the direct
   ``make_retrieval_fn`` call on the same padded batches on the card;
   ``/healthz`` and a 400 for a request without ``holo``; one request to an
   int8 service and one to a service with ``refine_steps`` 10, each equal to
   its direct call. Each request's ASM launches are counted from 0 just
   before it and read just after, and must be what it implies: one
   ``asm_const`` a chunk and, with ``refine_steps`` n, n + 1 ``asm_dynamic``
   a chunk; the phase's launches are their sum (the direct calls and the
   timings run outside the counts). Holograms/s at batch 32 over HTTP,
   through ``RetrievalService.retrieve`` in process, and by the direct call
   on a batch already on the card, in bf16 and int8 (and fp32 direct), with
   the host's time for the npz wire format of a request. Then the service
   that ``serve --checkpoint checkpoints/rbc_release --quant auto`` runs
   (``cli.build_service``): its ``loaded`` lines must name rbc's release,
   sibling ``rbc_style_vector.npz`` and band-limited ``rbc_config.json``;
   requests of 5 and 37 holograms of the rbc stream over HTTP, each
   launching no kernel and equal bit for bit to the direct int8 call on the
   service's net with rbc's ``rbc_quant_scales.json`` and style vector,
   which the flagship's scales or style vector would each change; the
   requests' seconds and the direct call's ms at batch 32 printed.
12. ``stream`` — the golden suite through ``stream_retrieval`` and its
   pinned prefetch in batches of 8 (the last batch of 4 padded and
   trimmed), equal bit for bit to the per-batch retrieval, one
   ``asm_const`` a batch; frames/s.
13. ``eval``   — ``cli.main(["eval", ...])`` in process on the ``fast``
   release, with ``--json`` and ``--profile``: the printed metrics within
   0.005 dB (mean and held-out PSNR) and R² within 1e-4 of
   ``golden_metrics.json``; ``asm_const`` launched exactly once a batch (20),
   its 20 launches named in the ``torch.profiler`` Chrome trace on the host
   and on the card, with their 4 x 20 device GEMMs; where PIL and matplotlib import, 100 montages,
   the box plot and one ``metrics.jsonl`` line (else the phase runs with
   ``--save-dir ''``, the JAX CLI's switch-off, and says so). Then
   ``eval --refine 2``: ``asm_dynamic`` 20 x 3 times.
14. ``mat``    — the committed measured RBC tree
   (``tests/fixtures/rbc_mat_tree``) through the CLI: ``train --mat-root
   --domain red_blood_cell`` for 2 steps at 64^2 (the supervised term
   forced off), ``extract-style --mat-root --pt-out`` (the reference's
   ``.pt`` read back equal to the ``.npz``'s mean and std bit for bit) and
   ``eval --mat-root`` from its snapshot, ``stream --root``; the same
   snapshot's ``evaluate_mat_tree`` and style vector on the CPU: each
   batch's PSNR within 0.005 dB (the golden phase's fp32 limit) and each
   distance within 0.05 µm, the style vector within 1e-4 of max. The domain's band limit keeps every kernel off this path.
   Then ``eval --checkpoint checkpoints/rbc_release --mat-root ... --domain
   red_blood_cell --json`` at 128^2 with the trained weights (the CLI must
   load rbc's sibling style vector), against the port's
   ``evaluate_mat_tree`` on the CPU for the same release: each batch within
   0.005 dB, each distance within 0.05 µm, no kernel launched.
15. ``domain`` — the trained domain releases (``rbc_release``, ``bead_release``,
   width 1.0) through ``evaluate_synth_domain`` by their records' protocol
   (batches of 32 of the JAX package's ``jax.random`` stream, seed 7777,
   bank seed 7919), each path with every kernel's launches counted from 0
   just before it and read just after: fp32 over the record's 10 batches
   (the mean within 0.005 dB and R² within 1e-4 of
   ``<tag>_domain_metrics.json``; every batch within 0.005 dB and every
   distance within 3 µm of the port's CPU reading, the records' per-batch
   arrays being another run's); refined (200 steps rbc, 100 bead) over the
   10 batches, the mean within 0.05 dB and R² within 1e-4 of its record;
   refine-distance (60 steps, the distance refined too) over the first 5
   batches, within 0.05 dB and R² 1e-4 of the port's CPU reading of those
   5 (the phase's time allows no more), the 10-batch record printed; int8
   in bf16 with the stacks off over the int8 record's 3 batches, within
   0.05 dB and R² 1e-4 of the port's CPU reading (the int8 records were
   taken elsewhere, both packages miss them alike), the record printed; the
   same with the stacks on, printed, one head and one tail launch a batch,
   each on the tensor cores. No ASM kernel launches on these band-limited paths. Then the
   stream's first batch through ``retrieval_step`` with the ``cuda`` ring
   (exactly 20 ``border_lines`` launches) against ``matpad``, by the slice
   phase's rules. Last, the band-limited refocus at B = 32 timed through
   ``torch.fft`` beside the same refocus without the band limit, through
   ``torch.fft`` and ``asm_const``.
16. ``train``  — training at the flagship's configuration
   (``checkpoints/config.json``: width 1.0, 128², B = 32, adversarial 1.0,
   EMA 0.999, clip 1.0, the encoder trained) on the golden train-split
   digits: (a) ``train()`` from ``init_net_params`` seed 0, TRAIN_STEPS
   steps, every loss term finite, ``asm_dynamic`` launched twice a step
   (the synthesis) with the counts reset just before and read just after;
   (b) one step at B = 2 on the card against the CPU from the same params
   and batch (aux, the gradients of both against a float64 evaluation on
   the card, the optimizer given the same gradients, the states); (c) the
   same draws rendered through ``asm_dynamic`` and ``torch.fft``; (d) the
   ``cuda`` ring's gradients (the op ``border_lines``) at each of a step's reflect
   convs against ``matpad`` and ``einsum``, and one train step with the
   ring against ``matpad`` (38 ring launches); (e) TRAIN_LEARN_STEPS steps
   on a fixed batch at lr 1e-4, the total loss must fall, timed with CUDA
   events and split into synthesis, generator forward+backward,
   optimizer+EMA and the discriminator's step, with the peak memory.
   Mixed precision and ``remat``: (f) the committed ``w125`` recipe
   (``checkpoints_w125/config.json``: width 1.25, bf16, the warp on) through
   ``train()`` for W125_STEPS steps at B = 32 (every loss finite, params and
   moments fp32, ``asm_dynamic`` twice a step and nothing else), ``cli train
   --dtype bfloat16`` with its batch, warp and weights, then TRAIN_TIMED
   steps timed with the peak memory; (g) the flagship in bf16 at
   B = 2 from (b)'s params and batch: the step on the card against the CPU
   (aux within 1e-2), the gradients of the card, the CPU, the card with the
   ``cuda`` ring and a control one bit coarser than bf16 against float64
   ones on BF16_GRAD_BATCHES batches (``bf16_distance_shares``; the control
   must fail), the ring launched at each of the step's 38 reflect convs in
   bf16, each call within one bf16 ulp of ``border_lines_plain``; (h) at
   B = 32 with dropout on, under ``torch.use_deterministic_algorithms``, a
   ``remat`` step's gradients against REMAT_PLAIN_STEPS plain steps' in
   fp32 (``auto``) and bf16 (the ``cuda`` ring, its launches with and
   without ``remat``), the flagship's steps timed in bf16 and with
   ``remat`` in fp32 and bf16 (fp32 without it is (e)), and the bf16 ring
   at each of the step's reflect convs beside its plain version and its
   bound.
17. ``export`` — (after ``domain``) the frozen serving artifact: ``fast``
   exported with ``torch.export`` from ``torch_weights.npz`` (fp32, batch
   32, the refocus as the op ``holostyle::asm_const``, ``("cuda",)``), and
   in int8 with the stacks on, into a temp directory by a fresh process on
   the card (``EXPORTER``) that starts after ``conv_kernels`` and runs
   beside the phases between, its seconds and bytes; once it is written,
   the file loaded in a fresh process and ``RetrievalService`` built from
   the checkpoint in another, each timed from
   the process's start to its imports, its program and its first answer
   (the artifact's process must import no model code and no JAX); the
   artifact against
   the live ``RetrievalService`` (fp32, the ``cuda`` refocus) on golden
   batch 10 (``ARTIFACT_TOL``); the whole suite through
   ``evaluate_golden_suite(retrieval_fn=...)`` over the artifact within the
   ``golden`` phase's limits of ``golden_metrics.json``, ``asm_const``
   counted at exactly 20 launches; the int8 export with the stacks on (its
   graph holds the head and tail ops) against the live int8 stacks-on
   path; one HTTP round trip through ``ArtifactService``; CUDA-event
   medians of the artifact's call and the live call at batch 32.
18. ``commands`` — ``cli synth-bench`` at batch 256 (its line, 51
   ``asm_dynamic`` launches); ``cli sweep`` on ``fast`` (3 ``asm_dynamic``
   launches), its functions card against CPU and its montage against the
   CPU's; ``cli doctor`` lists the card and reports ``transport_ready`` not
   applicable; ``stylize`` card against CPU.

19. ``parallel`` — (after ``train``, before ``timing``) the mesh layer
   (``parallel/``): a 1-rank ``nccl`` world in this process
   (``parallel.init_world``) through ``train()``, as ``cli train --devices
   N`` runs each rank, ``dp`` and ``tp_fsdp`` on a (1, 1) mesh, at the
   flagship's configuration, B = 4, 2 steps, against ``train()`` without
   a mesh (losses, each step's gradients, and params, EMA and
   discriminator beside Adam replayed on each run's gradients); one
   spawn of a 2-rank ``gloo`` world on ``cuda:0``
   (``parallel.launch``; started after ``conv_kernels`` so that its
   ranks' cold start, the import of ``torch._dynamo`` at a process's first
   ``torch.library`` op call, the CUDA context and cuDNN, overlaps the
   phases before this one, none of which times what the kernels line
   prints, then held until this phase releases it) running ``dp``, ``zero1``,
   ``fsdp`` and ``tp`` in turn, 2 steps each at B = 4 without
   the adversarial term and with the ``cuda`` ring, each first step's aux,
   whole gradients and params against the one-process step on the card,
   each rank's ``asm_dynamic`` and ``border_lines`` launches counted; the
   collectives gloo carries on CUDA tensors, a partition whose collectives
   it refuses named with the error; then, in the same world, the
   FOV-sharded refocus (``parallel.sharded_propagate``) of a
   (2, 1, 1024, 1024) field padded to 2048^2 on each rank's rows against
   ``propagate_torch`` of the whole field, with and without the band limit,
   and the GPipe pipeline on a 2-stage ``pipe`` mesh at the flagship's width
   and 128^2 (seed-0 weights): the retrieval at B = 8, 4 microbatches,
   against the one-process ``retrieval_step`` with the torch refocus, the
   fine-tune and the full training with the adversarial term (its
   discriminator replicated), 2 steps each at B = 4, 2 microbatches, the
   first step's loss terms and whole gradient against the one-process
   objective's; each rank's ``ppermute``, ``all_to_all`` and
   ``exchange_rows`` calls and bytes, a part whose collective gloo refuses
   skipped and named; the 1-rank NCCL world runs the 1-shard refocus and
   the 1-stage retrieval; and a 2-position serving mesh on
   ``cuda:0`` (``RetrievalService(mesh=...)``, ``fast`` in fp32, batch 32)
   against one device, one ``asm_const`` a chunk.
20. ``ablations`` — (after ``parallel``, before ``timing``) the last
   modules of the port: (a) ``TrivialSolutionNet`` (width 1.0, weights from
   ``torch.Generator`` seed 0) on golden batch 10 tiled to B = 32 with the
   reflect backend ``cuda``, the ring's launches counted from 0 just before
   and read just after (exactly 20 a forward, one a reflect conv), against
   the same forward with ``matpad`` and, on the batch of 5, against the
   port on the CPU, both by the slice phase's rules; (b) ``HoloAutoEncoder()``
   at its full widths (64..1024) at B = 8, instance norm with skips (at
   B = 1 against the CPU within 1e-4 of max), group norm, batch norm in
   train mode (its running averages move) and without skips; (c) the
   refocused phase of (a)'s outputs unwrapped on the card by the matmul DCT
   in ``highest`` and ``high`` and by the fft DCT, each congruent to its
   input and, snapped, equal to ``highest``'s in 99.9 % of the pixels; the
   fft and the matmul DCT, and the card and the CPU, within 1e-4 of max
   before the snap (``high``'s distance printed); ``unwrap_phase_native`` on
   the host beside them, printed; (d) the
   reference's checkpoint files written at full width from seeded tensors
   (its stem RGB) through ``load_reference_checkpoint`` and
   ``retrieval_step`` on golden batch 10, on the card against the CPU.

Then the ``nvidia-smi`` line, one JSON line listing every kernel, and the
final JSON line ``{"ok": true, "device": {...}}``. Any failure exits
non-zero before that line. The script imports the port (and the port's
``scripts/port_exp_halo_conv.py``), torch, numpy and the standard library
only.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import dataclasses
import functools
import importlib.util
import io
import json
import math
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

_t_start = time.monotonic()
REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
# The cuBLAS workspace setting under which torch.use_deterministic_algorithms
# accepts cuBLAS (the `train` phase's remat check); read when the first
# cuBLAS handle is made.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
PORT = "style_transfer_based_holographic_imaging_tpu_torch"


class _Build(threading.Thread):
    """``_build.build(*names)`` on a thread of its own; ``result`` waits for
    it (the waiting phase's watchdog bounds the wait) and returns its
    seconds, or raises its error."""

    def __init__(self, build_module, *names: str):
        super().__init__(daemon=True)
        self.build_module, self.names = build_module, names
        self.seconds, self.error = None, None
        self.start()

    def run(self):
        try:
            self.seconds = self.build_module.build(*self.names)
        except BaseException as e:  # noqa: BLE001 — raised again by result()
            self.error = e

    def result(self) -> dict:
        self.join()
        if self.error is not None:
            raise self.error
        return self.seconds


def _start_builds() -> dict:
    """Start every kernel source's ``nvcc`` before torch's import, which
    takes about 10 s on the card's host: ``kernels/_build.py`` imports no
    torch, so it is loaded here by its path, under its package name, where
    the port's kernel modules find it when they import it. Stale build files
    go first. The ASM source builds on one thread (the first phases launch
    only its kernels), the other three on another, the zstd decoder (a host
    C++ source, ``interop/csrc/zstd_decode.cc``, the orbax reader's) on a
    third."""
    name = f"{PORT}.kernels._build"
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, PORT, "kernels", "_build.py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    removed = module.remove_stale()
    return {"removed_stale": removed, "asm": _Build(module, "asm_propagate"),
            "rest": _Build(module, *(s for s in module.SOURCES if s != "asm_propagate")),
            "zstd": _Build(module, *module.HOST_SOURCES)}


_BUILDS = _start_builds() if __name__ == "__main__" else None

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.func import functional_call  # noqa: E402

from style_transfer_based_holographic_imaging_tpu_torch import ExperimentConfig  # noqa: E402
from style_transfer_based_holographic_imaging_tpu_torch import cli as port_cli  # noqa: E402
from style_transfer_based_holographic_imaging_tpu_torch.config import (  # noqa: E402
    DOMAIN_PRESETS,
    DataConfig,
    PhysicsConfig,
)
from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite  # noqa: E402
from style_transfer_based_holographic_imaging_tpu_torch.data import synth  # noqa: E402
from style_transfer_based_holographic_imaging_tpu_torch.data.mat_sampler import (  # noqa: E402
    MeasuredHologramSampler,
)
from style_transfer_based_holographic_imaging_tpu_torch.interop import (  # noqa: E402
    convert_params,
    load_reference_checkpoint,
    load_release_weights,
    load_style_vector,
    load_style_vector_pt,
    ocdbt,
    orbax_read,
)
from style_transfer_based_holographic_imaging_tpu_torch.eval import psnr, zero_mean  # noqa: E402

from style_transfer_based_holographic_imaging_tpu_torch.kernels import (  # noqa: E402
    _build,
    asm_cuda,
    conv_stack,
    halo_conv,
    library,
    reflect_border,
)
from style_transfer_based_holographic_imaging_tpu_torch.models import (  # noqa: E402
    ConvTranspose2x2,
    HoloAutoEncoder,
    PatchDiscriminator,
    ReflectConv,
    StyleTransferNet,
    init_net_params,
    init_params,
    set_reflect_backend,
    split_style_vector,
    TrivialSolutionNet,
)
from style_transfer_based_holographic_imaging_tpu_torch.models import layers, quant  # noqa: E402
from style_transfer_based_holographic_imaging_tpu_torch.ops import (  # noqa: E402
    holo_forward,
    set_dct_backend,
    set_dct_precision,
    unwrap_phase,
    unwrap_phase_native,
)
from style_transfer_based_holographic_imaging_tpu_torch.ops import asm as asm_ops  # noqa: E402
from style_transfer_based_holographic_imaging_tpu_torch.ops.asm import propagate, propagate_torch  # noqa: E402
from style_transfer_based_holographic_imaging_tpu_torch.ops.stats import (  # noqa: E402
    adain_with_stats,
    calc_mean_std,
)
from style_transfer_based_holographic_imaging_tpu_torch import parallel  # noqa: E402
from style_transfer_based_holographic_imaging_tpu_torch import pipelines as port_pipelines  # noqa: E402
from style_transfer_based_holographic_imaging_tpu_torch.pipelines import (  # noqa: E402
    ArtifactService,
    RetrievalService,
    StreamStats,
    evaluate_golden_suite,
    evaluate_mat_tree,
    evaluate_synth_domain,
    make_retrieval_fn,
    physics_refine,
    refine_retrieval,
    retrieval_step,
    retrieve_remote,
    serve_forever,
    stream_retrieval,
    stylize,
)
from style_transfer_based_holographic_imaging_tpu_torch.pipelines.export_artifact import (  # noqa: E402
    load_artifact,
)
from style_transfer_based_holographic_imaging_tpu_torch.pipelines.style_vector import (  # noqa: E402
    style_vector_from_holograms,
)
from style_transfer_based_holographic_imaging_tpu_torch.train import (  # noqa: E402
    TrainStep,
    create_train_state,
    generator_loss_fn,
    latest_snapshot,
    load_train_params,
    lsgan_d_loss,
    train,
)
from style_transfer_based_holographic_imaging_tpu_torch.train.losses import (  # noqa: E402
    distance_loss,
    style_plane_target,
)
from style_transfer_based_holographic_imaging_tpu_torch.train.state import (  # noqa: E402
    Adam,
    apply_disc_gradients,
    apply_gradients,
    make_disc_optimizer,
    make_optimizer,
)
from style_transfer_based_holographic_imaging_tpu_torch.utils import jax_random  # noqa: E402
from style_transfer_based_holographic_imaging_tpu_torch.utils.bench import (  # noqa: E402
    head_library,
    median_ms,
    recording_ring_layers,
    ring_inputs,
    seeded_stack,
    time_ring_layers,
)


def _load_script(name: str):
    path = os.path.join(REPO, "scripts", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# The halo tail's experiment: its rows are the halo phase's timed rows.
halo_exp = _load_script("port_exp_halo_conv")

TOTAL_BUDGET_S = 285.0
BUDGETS_S = {
    "device": 60.0, "build": 150.0, "kernels": 90.0, "slice": 90.0, "refine": 60.0,
    "conv_kernels": 90.0, "quant": 90.0, "reflect": 60.0, "halo": 60.0, "golden": 60.0, "serve": 90.0,
    "stream": 30.0, "eval": 30.0, "mat": 30.0, "domain": 30.0, "release": 25.0, "narrow_releases": 20.0, "export": 45.0, "commands": 30.0,
    "train": 90.0, "parallel": 45.0, "ablations": 20.0, "timing": 120.0,
}
TOLERANCES = {"highest": 1e-5, "high": 1e-4, "bf16": 2e-2}
# (B, H, W) where the ASM kernels' tensor-core tiles are ragged: the card
# tests' (1, 16, 16) and (2, 48, 64); (2, 48, 80); (2, 40, 56), whose M, N
# and K are off a multiple of 64 in all four stages; (2, 18, 30), whose
# operand rows are padded to 8 elements.
ODD_SHAPES = ((1, 16, 16), (2, 48, 64), (2, 48, 80), (2, 40, 56), (2, 18, 30))
# Card tolerances for the same golden batch on the card (cuDNN fp32 convs,
# the "high" DFT kernel) against the CPU (fp32 convs, the torch.fft path):
# max|err| / max|ref| of amp_foc, |err| of distance_pred (in (0, 1)), and the
# phase compared modulo 2 pi (the congruence snap may move a pixel at a tie
# by a whole 2 pi) in at least PHASE_FRACTION of the pixels.
SLICE_AMP_TOL = 1e-3
SLICE_DIST_TOL = 1e-4
SLICE_PHASE_TOL = 1e-2
SLICE_PHASE_FRACTION = 0.999
# The conv kernels against their plain versions, by dtype (see the docstring).
CONV_TOLERANCES = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# The int8 path on the card against the same port on the CPU, one golden
# batch, in fp32 and in bf16 compute. Every call of these ops in the card's
# run is recomputed on the CPU from the same inputs: the int8 convs must
# agree bit for bit (the int32 sums are exact, the rest single IEEE
# operations on both), the stacks and the transposed convs within
# CONV_TOLERANCES. The two runs' own inputs part where the fp parts sum in
# other orders and an activation crosses a rounding tie: it requantizes to
# the neighbouring int8 step. The run counts those steps call by call, and
# measures what one step in the first int8 conv's input moves at the
# output (``one_int8_step``). On the seeded net, golden batch 10, that one
# step moves amp_foc by 14.5 % (fp32) and 12.5 % (bf16) of max|ref|, 5.8 %
# and 5.7 % in L2 norm (NVIDIA H100 80GB HBM3, 700 W; this script). The
# whole path's outputs are held to QUANT_PATH_TOL, about 2.5 times those
# readings; the path with no int8 conv (empty scales: the stacks, cuDNN and
# the transposed convs in fp32, nothing to requantize) is held to the
# slice's tolerances.
QUANT_OPS = ("int8_conv_valid", "fused_encoder_head", "fused_conv_tail", "conv_in_dtype")
QUANT_PATH_TOL = {
    torch.float32: {"amp_foc_rel_err": 0.35, "amp_foc_rel_l2": 0.15, "distance_pred_abs_err": 1e-3},
    torch.bfloat16: {"amp_foc_rel_err": 0.35, "amp_foc_rel_l2": 0.15, "distance_pred_abs_err": 0.05},
}
# The net's reflect convs: 9 in the encoder, 11 in the decoder.
REFLECT_CONVS = 20
# Layers of the border ring's checks: (C, H, W, O) of three of the net's
# reflect convs, one odd H, and short lines that share a block of 128 ring
# positions with output channels off a multiple of 64; the first is timed.
RING_LAYERS = ((64, 128, 128, 64), (3, 128, 128, 64), (64, 64, 64, 128), (512, 16, 16, 256),
               (64, 127, 128, 64), (64, 16, 16, 40), (256, 32, 32, 96))
# Physics refinement: the ASM ops' gradients against propagate_torch
# autograd, max|err| / max|ref| (the JAX package's gradient budget, rtol
# 1e-3); the refine of golden batch 10 from its GT phase plus REFINE_NOISE_RAD
# of noise, on the card against the CPU, PSNR within REFINE_DB_TOL.
GRAD_TOL = 1e-3
REFINE_STEPS = 100
REFINE_BATCH = 10
REFINE_NOISE_RAD = 0.3
REFINE_DB_TOL = 0.05
REFINE_PAIRS = 4  # timed refines through each backend at B_TIMING
B_TIMING = 256
IMAGE = 128
SERVING_REFOCUS_M = -2e-4  # -d_style = -0.2 mm, the golden suite's style plane
# The fast release on the card, held to its records (PERF.md section 2):
# fp32 every batch within GOLDEN_BATCH_DB and every distance within
# GOLDEN_UM (tests/test_torch_release_gate.py); int8 and the bf16 fp net the
# mean within SUITE_DB and R² within SUITE_R2; refined the mean and held-out
# within REFINE_DB_TOL (tests/test_torch_refine.py).
FAST = os.path.join(REPO, "checkpoints", "fast")
# The flagship release (the `release` phase): its orbax weights, config,
# style vector, int8 scales and records.
FLAGSHIP = os.path.join(REPO, "checkpoints")
# The narrow MNIST releases (the `narrow_releases` phase): checkpoints/<name>
# at widths 0.75, 0.375 and 0.25, each through run_golden's fp32 and int8
# paths (NARROW_PATHS). ultra's int8 R² is held to the port's CPU reading
# (GOLDEN_CPU_READINGS, written by `scripts/port_golden_eval.py --save`),
# since both packages miss its record alike (ROADMAP C.2); its mean to the
# record. The refine with the distance (`eval --refine N --refine-distance`)
# at the records' NARROW_REFINE_DISTANCE_STEPS on the first
# NARROW_REFINE_DISTANCE_BATCHES batches of balanced and turbo, held to the
# port's CPU reading of those batches at FEW_THREADS torch threads (the
# refine with the distance moves with them, ROADMAP C.7): the mean within
# REFINE_DB_TOL and R² within SUITE_R2; the 20-batch records printed. Then
# `cli eval --refine NARROW_CLI_REFINE_STEPS --refine-distance` on turbo in
# process against the direct call with the same arguments: each batch's
# PSNR within CLI_REPEAT_DB (repeated refines on the card part by up to
# 2e-4 dB, PERF.md section 6) and each distance within CARD_CPU_UM.
NARROW_RELEASES = ("balanced", "turbo", "ultra")
NARROW_PATHS = ("fp32", "int8_stacks_off", "int8_stacks_on")
NARROW_INT8_R2_FROM_CPU = ("ultra",)
NARROW_REFINE_DISTANCE = ("balanced", "turbo")
NARROW_REFINE_DISTANCE_STEPS = 240
NARROW_REFINE_DISTANCE_BATCHES = 3
NARROW_CLI_RELEASE = "turbo"
NARROW_CLI_REFINE_STEPS = 10
FEW_THREADS = 2
CLI_REPEAT_DB = 2e-4
GOLDEN_CPU_READINGS = os.path.join(REPO, "checkpoints", "port_cpu_golden_readings.json")
GOLDEN_BATCH_DB = 0.3
# fp32 every batch also within GOLDEN_FP32_BATCH_DB, tight enough to tell
# fp32 from bf16: the card's fp32 reads 4.4e-5 dB at most on a batch, the
# fp net in bf16 0.013 dB off the fp32 mean (PERF.md section 6).
GOLDEN_FP32_BATCH_DB = 0.005
GOLDEN_UM = 3.0
SUITE_DB = 0.05
SUITE_R2 = 1e-4
# The serve phase: request sizes (one, a golden batch, more than a batch:
# chunked and padded), the service's batch, the refine request's steps and
# the timed requests a path; the stream's batch.
SERVE_REQUESTS = (1, 5, 37)
SERVE_BATCH = 32
SERVE_REFINE_STEPS = 10
SERVE_TIMED = 5
WIRE_TIMED = 2
STREAM_BATCH = 8
# The eval phase: `cli eval` on the fast release, its metrics within
# EVAL_DB of the record (mean and held-out PSNR) and R² within EVAL_R2, one
# asm_const a batch; then `eval --refine EVAL_REFINE_STEPS`, whose steps and
# final residual are EVAL_REFINE_STEPS + 1 asm_dynamic a batch. The mat
# phase: the committed RBC tree through train (MAT_TRAIN_STEPS at
# MAT_IMAGE^2), extract-style, eval and stream; card against the port on the
# CPU with the same weights, each batch's PSNR within GOLDEN_FP32_BATCH_DB
# (fp32 paths: a net that ran in bf16 or TF32 would miss it) and each
# distance within CARD_CPU_UM, the style vector within STYLE_TOL of max. The
# mat phase's `eval --mat-root` on rbc_release at IMAGE^2 is held to the same
# release on the CPU by the same limits. The band-limited refocus is timed at
# DOMAIN_BATCH in the domain phase. CARD_CPU_UM is five times the largest
# card-against-CPU distance read when it was set, 0.0098 µm (PERF.md
# section 6), as the golden phase's GOLDEN_UM is set against its record.
# The eval phase's profiler trace holds each asm_const launch as a region on
# the host and on the card and ASM_TC_GEMMS device GEMMs (asm_propagate.cu's
# four tc_gemm_kernel launches a call).
EVAL_DB = 0.005
EVAL_R2 = 1e-4
EVAL_REFINE_STEPS = 2
CARD_CPU_UM = 0.05
ASM_TC_GEMMS = 4
MAT_TREE = os.path.join(REPO, "tests", "fixtures", "rbc_mat_tree", "red_blood_cell")
MAT_IMAGE = 64
MAT_TRAIN_STEPS = 2
STYLE_TOL = 1e-4
DOMAIN_BATCH = 32
# The domain releases (checkpoints/<tag>_release, width 1.0) by the records'
# protocol: (preset, eval bank, the refined record's steps), the stream and
# bank seeds, the refine-distance record's steps and the batches the phase
# refines so (the first DOMAIN_REFINE_DISTANCE_BATCHES: all 10 would take the
# phase past its budget). Held to <tag>_domain_metrics.json: the fp32 mean
# within GOLDEN_FP32_BATCH_DB and R² within SUITE_R2, refined the mean
# within REFINE_DB_TOL and R² within SUITE_R2. Where the records cannot be
# reproduced by either package, the card is held to the port's own CPU
# reading (DOMAIN_CPU_READINGS, written by `scripts/port_domain_eval.py
# --save`, the command beside each reading): the fp32 records' per-batch
# PSNRs and distances are not the run their means and R² come from (they
# average to another mean; ROADMAP C.8), so every fp32 batch is held within
# GOLDEN_FP32_BATCH_DB and every distance within GOLDEN_UM of the port's
# CPU reading; the int8 records were taken on another stream or release
# (ROADMAP C.6), so the int8 path in bf16 with the stacks off is held to the
# port's CPU reading by the int8 rule (SUITE_DB, SUITE_R2). Refine-distance
# on its 5 batches is held to the port's CPU reading of those batches by the
# refined rule (REFINE_DB_TOL, SUITE_R2). The records' figures are printed
# beside.
DOMAINS = {"rbc": ("red_blood_cell", synth.rbc_bank, 200), "bead": ("polystyrene", synth.bead_bank, 100)}
DOMAIN_STREAM_SEED = 7777
DOMAIN_BANK_SEED = 7919
DOMAIN_REFINE_DISTANCE_STEPS = 60
DOMAIN_REFINE_DISTANCE_BATCHES = 5
DOMAIN_CPU_READINGS = os.path.join(REPO, "checkpoints", "port_cpu_domain_readings.json")
RBC_RELEASE = os.path.join(REPO, "checkpoints", "rbc_release")
# The export phase: `fast` frozen at EXPORT_BATCH through the asm_const op;
# the artifact against the live RetrievalService on one golden batch within
# ARTIFACT_TOL of max (bit for bit expected: the same aten graph on the
# same card), the suite through it within the golden phase's limits with
# one asm_const a batch, the int8 export with the stacks on against the
# live int8 path alike, one HTTP round trip; cold starts in fresh processes
# (COLD_TIMEOUT_S each); EXPORT_TIMED calls of each path timed. The two
# exports run in a process of their own (EXPORTER, EXPORT_TIMEOUT_S). The
# commands phase: `synth-bench` at SYNTH_BENCH_BATCH (SYNTH_BENCH_REPS + 1
# asm_dynamic launches: the warm-up and the timed calls), `sweep` on `fast`
# (two asm_dynamic for the synthesis, one for the per-plane refocus), card
# against CPU: holograms within SYNTH_TOL, each plane's PSNR within
# GOLDEN_FP32_BATCH_DB, distances within GOLDEN_UM, the written montage
# within one grey level of the CPU's on all but GREY_SHARE of its pixels;
# `doctor`; `stylize` card against CPU within SLICE_AMP_TOL.
EXPORT_BATCH = 32
ARTIFACT_TOL = 1e-6
COLD_TIMEOUT_S = 60.0
EXPORT_TIMEOUT_S = 150.0
EXPORT_TIMED = 10
SYNTH_BENCH_BATCH = 256
SYNTH_BENCH_REPS = 50
SWEEP_DISTANCES = (0.2, 0.4, 0.6, 0.8)
SWEEP_LAUNCHES = {"asm_const": 0, "asm_dynamic": 3}
GREY_SHARE = 1e-3
# A fresh process's first answer: argv is the repo, what to load, the
# holograms' .npy. It prints when (time.time()) its imports were done, its
# program was loaded and it answered, the port's modules it imported, and
# whether JAX is among them.
_COLD_TAIL = r"""
torch.cuda.synchronize()
answered_at = time.time()
port = "style_transfer_based_holographic_imaging_tpu_torch."
mods = sorted(m[len(port):] for m in sys.modules if m.startswith(port))
print(json.dumps({"imported_at": imported_at, "loaded_at": loaded_at, "answered_at": answered_at,
                  "ph_foc_sum": float(out["ph_foc"].sum()),
                  "model_code": [m for m in mods
                                 if m.startswith("models") or m == "pipelines.field_retrieval"],
                  "jax": "jax" in sys.modules}))
"""
COLD_ARTIFACT = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from style_transfer_based_holographic_imaging_tpu_torch.pipelines.export_artifact import load_artifact
imported_at = time.time()
art = load_artifact(sys.argv[2])
loaded_at = time.time()
out = art.retrieve(np.load(sys.argv[3]))
""" + _COLD_TAIL
COLD_LIVE = r"""
import json, os, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
from style_transfer_based_holographic_imaging_tpu_torch.config import ExperimentConfig
from style_transfer_based_holographic_imaging_tpu_torch.interop import load_release_weights, load_style_vector
from style_transfer_based_holographic_imaging_tpu_torch.models import StyleTransferNet
from style_transfer_based_holographic_imaging_tpu_torch.pipelines.server import RetrievalService
imported_at = time.time()
with open(os.path.join(sys.argv[2], "config.json")) as f:
    cfg = ExperimentConfig.from_json(f.read())
net = StyleTransferNet.from_state_dict(
    load_release_weights(os.path.join(sys.argv[2], "torch_weights.npz")), cfg.model.width)
style = load_style_vector(os.path.join(sys.argv[2], "style_vector.npz"))
service = RetrievalService(net, style, cfg, batch_size=32)
loaded_at = time.time()
out = service.retrieve(np.load(sys.argv[3]))
""" + _COLD_TAIL
# The export phase's two exports of a release in a fresh process on the
# card: fp32, and int8 with the fused stacks on. torch.export traces on the
# host, 15-35 s of the two on the card's host: the process starts once every
# kernel is built and runs beside the phases before the export phase. argv:
# the repo, the release, the batch, the output directory. Prints each
# artifact's path, its export's seconds (the save included) and its ops.
EXPORTER = r"""
import json, os, sys, time
sys.path.insert(0, sys.argv[1])
from style_transfer_based_holographic_imaging_tpu_torch.config import ExperimentConfig
from style_transfer_based_holographic_imaging_tpu_torch.interop import load_release_weights, load_style_vector
from style_transfer_based_holographic_imaging_tpu_torch.models import StyleTransferNet, quant
from style_transfer_based_holographic_imaging_tpu_torch.pipelines.export_artifact import (
    export_retrieval, save_artifact)
release, batch, out_dir = sys.argv[2], int(sys.argv[3]), sys.argv[4]
with open(os.path.join(release, "config.json")) as f:
    cfg = ExperimentConfig.from_json(f.read())
net = StyleTransferNet.from_state_dict(
    load_release_weights(os.path.join(release, "torch_weights.npz")), cfg.model.width).to("cuda")
style = load_style_vector(os.path.join(release, "style_vector.npz"))
scales = quant.load_scales(os.path.join(release, "quant_scales.json"))
out = {}
for name, kw, stacks in (("fp32", {}, "auto"), ("int8", {"quant_scales": scales}, "on")):
    quant.set_fused_stacks(stacks)
    t0 = time.time()
    blob, meta = export_retrieval(net, style, cfg, batch_size=batch, asm_backend="cuda", **kw)
    path = os.path.join(out_dir, f"fast_{name}.hstx")
    save_artifact(path, blob, meta)
    out[name] = {"path": path, "seconds": time.time() - t0, "ops": meta["ops"]}
print(json.dumps(out))
"""
# The train phase: steps of train() at the flagship's batch; the one-step
# comparisons' batch; the fixed-batch run at TRAIN_LEARN_LR, its first
# TRAIN_WARMUP steps untimed. Tolerances: aux terms 1e-4 relative. The
# generator's gradients of each fp32 path (card, CPU, the cuda ring) within
# TRAIN_GRAD_TOL of each leaf's max of a float64 evaluation of the same loss
# on the card: at width 1.0 the early encoder weights' gradients sum some
# 32,000 products of a large mean and a zero-mean factor, and the nearly
# empty decoder leaves at init cancel; both fp32 paths read up to 1.1e-3
# there (card 1.0e-3, CPU 8.8e-4, the ring 1.1e-3; NVIDIA H100 80GB HBM3,
# 700 W, this phase's functions). The optimizer and EMA given the same
# gradients: TRAIN_OPT_TOL of each leaf's max. The whole step's params, EMA
# and discriminator: every element within TRAIN_LEAF_TOL of its leaf's max
# plus the spread of Adam's first step, lr g/(|g| + eps), over the
# gradients within the leaf's measured fp32 noise (the two runs' largest
# distance from the float64 gradient) of the float64 one: nothing where
# |g| is far above the noise and eps, up to 2 lr where the noise reaches
# zero and the sign is free. The synthesis's
# holograms: the `high` kernel's 1e-4 of max, the phase objects 1e-5 (fp32
# pow, cos/sin and the warp's gather weights on each device; read 3.9e-6);
# the ring's gradients 1e-4.
TRAIN_STEPS = 20
TRAIN_CMP_BATCH = 2
TRAIN_LEARN_STEPS = 30
TRAIN_LEARN_LR = 1e-4
TRAIN_WARMUP = 5
TRAIN_AUX_RTOL = 1e-4
TRAIN_GRAD_TOL = 2e-3
TRAIN_OPT_TOL = 1e-6
TRAIN_LEAF_TOL = 1e-4
ADAM_EPS = 1e-8
SYNTH_TOL = 1e-4
SYNTH_OBJECT_TOL = 1e-5
RING_GRAD_TOL = 1e-4
RING_GRAD_BATCH = 2
# Mixed precision and remat (the train phase's (f)-(h)): the w125 recipe
# through train() for W125_STEPS steps, then TRAIN_TIMED steps timed after
# TRAIN_TIMED_WARMUP; the flagship's bf16 and remat steps REMAT_TIMED after
# REMAT_WARMUP. A bf16 step on the card against the CPU: aux within
# BF16_AUX_RTOL relative. Its gradients' L2 distances from float64, each
# over its leaf's norm, on BF16_GRAD_BATCHES batches (bf16_distance_shares):
# a decoder leaf's median within BF16_GRAD_RATIO times the yardstick's
# (the CPU's for the card, the card's matpad for the cuda ring) plus
# BF16_GRAD_SLACK; the encoder's and the distance head's leaves share one
# ill-conditioned factor a batch (the physics loss's gradient through the
# distance head: on eight batches one leaf read 0.5-19 % on the CPU, 1.6-28
# % on the card, their ratio 0.5-5.8 a batch), so their median ratio over
# the group, its median over the batches, within BF16_GRAD_RATIO. On those
# eight batches the card read at most 0.52 of the decoder's bound and 0.73
# of the group's, and a control one bit coarser than bf16 (every conv's
# output and the gradient into it) at least 2.64 of the decoder's, which the
# run requires (scripts/port_exp_bf16_train.py; NVIDIA H100 80GB HBM3,
# 700.00 W). remat: under torch.use_deterministic_algorithms the remat step
# within REMAT_SPREAD times the largest difference between two of
# REMAT_PLAIN_STEPS plain steps, which repeat bit for bit there (without it
# each pair of steps, plain or remat, read 1.6e-6 to 2.5e-6 of a leaf's max
# in fp32 and up to 0.0122 in bf16: the backward's atomic adds, which
# cuDNN's deterministic mode alone does not remove). The ring launched at
# each of a step's REFLECT_STEP_CONVS reflect convs (three encoder passes
# of 9, the decoder's 11), each call within one bf16 ulp of its plain
# version's max (the fp32 sums' order).
W125_CONFIG = os.path.join(REPO, "checkpoints_w125", "config.json")
W125_STEPS = 3
TRAIN_TIMED = 20
TRAIN_TIMED_WARMUP = 3
REMAT_TIMED = 5
REMAT_WARMUP = 1
REMAT_PLAIN_STEPS = 2
REMAT_SPREAD = 2.0
BF16_AUX_RTOL = 1e-2
BF16_GRAD_BATCHES = 2
BF16_GRAD_RATIO = 2.0
BF16_GRAD_SLACK = 1e-3
REFLECT_STEP_CONVS = 3 * 9 + 11
# The mesh layer (the parallel phase): PARALLEL_STEPS steps at a global batch
# of PARALLEL_BATCH at the flagship's configuration. A 1-rank nccl world
# through train() (dp, and tp_fsdp on a (1, 1) mesh, whose collectives run
# over groups of one) against train() without a mesh: the logged losses
# within PARALLEL_LOSS_RTOL; the first step's gradients within
# PARALLEL_GRAD_TOL of the leaf's max (read: 0.026-0.034 of it), the second's,
# taken at params that the first step's Adam already parted, within
# PARALLEL_LATER_GRAD_TOL (read: 3.4e-4 to 9.0e-4 of the leaf's max in the
# flagship's encoder; a gradient scaled by 2 would read 0.5); the params, EMA
# and discriminator after the run within TRAIN_LEAF_TOL of each leaf's max
# plus PARALLEL_SPREAD times the gap that Adam, replayed in float64 on each
# run's gradients, puts between them (read: the gap itself, 0.45-0.50 of
# the bound): the 1-rank world's gradients are not the one-process run's
# bit for bit, and Adam's step parts by up to 2 lr where a gradient is
# near its noise (NVIDIA H100 80GB HBM3, 700.00 W). A 2-rank gloo world on
# cuda:0 for each partition of PARALLEL_PARTITIONS, without the adversarial
# term (its discriminator's 45 M weights through gloo's host-staged
# collectives would take the phase's budget), the reflect backend `cuda`.
# Each partition's first step against the one-process step on the card: aux within PARALLEL_LOSS_RTOL (the CPU
# tests' dp rule), the whole gradients within PARALLEL_GRAD_TOL of each
# leaf's max (a step's fp32 noise on the card: two identical steps read
# 1.6e-6 to 2.5e-6), the params within TRAIN_LEAF_TOL of the leaf's max plus
# the spread of Adam's first step over the gradients' measured difference.
# A serving mesh of 2 positions on cuda:0 against one device (fp32, the
# golden batch 10 and the next batches to 32).
PARALLEL_BATCH = 4
PARALLEL_STEPS = 2
PARALLEL_PARTITIONS = {"dp": (("data",), (2,)), "zero1": (("data",), (2,)), "fsdp": (("data",), (2,)),
                       "tp": (("data", "model"), (1, 2))}
# The collectives each partition's step runs (mesh.py's all_reduce,
# all_gather, reduce_scatter); barrier at the world's start.
PARALLEL_NEEDS = {"dp": ("all_reduce",), "zero1": ("all_reduce", "all_gather", "reduce_scatter"),
                  "fsdp": ("all_reduce", "all_gather", "reduce_scatter"),
                  "tp": ("all_reduce", "all_gather")}
PARALLEL_LOSS_RTOL = 2e-5
PARALLEL_GRAD_TOL = 1e-4
PARALLEL_LATER_GRAD_TOL = 1e-2
PARALLEL_SPREAD = 2.0
PARALLEL_SERVE_BATCH = 32
PARALLEL_TIMEOUT_S = 120.0
# The FOV-sharded refocus and the GPipe pipeline (parallel/fft_sharding.py,
# pp.py) in the same 2-rank gloo world on cuda:0, after the partitions, and
# in the 1-rank NCCL world (one shard, one stage). The refocus: a field a
# user would shard, (2, 1, 1024, 1024) complex64 padded to 2048^2, on the
# rank's rows, against propagate_torch of the whole field on the card
# within SHARDED_FFT_TOL of its max (the CPU tests' rule), with and
# without the band limit. The pipeline at the flagship's width and 128^2,
# seed-0 weights: retrieval on 2 stages at B = 8, n_micro 4, against the
# one-process retrieval_step with the torch refocus (the pipeline mirrors
# the JAX package's "xla" refocus): the fields, the distance and amp_foc by
# the CPU tests' tolerances (PP_RETRIEVAL_TOL), ph_foc by the serving
# mesh's rule (hold_retrieval says why); the fine-tune and the full
# training (the flagship's recipe, adversarial term on, its discriminator
# replicated, no collective), PP_STEPS steps each at B = 4, n_micro 2: the
# first step's loss terms within PARALLEL_LOSS_RTOL of the one-process
# objective's and its whole gradient (the stages' joined) within
# PARALLEL_GRAD_TOL of each leaf's max of the one-process gradient; the
# fine-tune's reference takes its forward in the pipeline's microbatches
# (finetune_objective: on one batch of 4 cuDNN sums in other orders, 9.2e-5
# of the leaf's max on the decoder's first layers, printed beside it).
PP_FIELD = (2, 1, 1024, 1024)
PP_FIELD_CASES = {"no_band_limit": ((3e-4, 7e-4), {}), "band_limit": ((6e-3, 1.2e-2), {"band_limit": True})}
SHARDED_FFT_TOL = 1e-5
PP_RETRIEVAL_BATCH, PP_RETRIEVAL_MICRO = 8, 4
PP_TRAIN_BATCH, PP_TRAIN_MICRO, PP_STEPS = 4, 2, 2
PP_LR = 1e-4
PP_D_STYLE = 0.2
PP_RETRIEVAL_TOL = {"amp_field": 1e-5, "ph_field": 1e-5, "distance_pred": 1e-5, "amp_foc": 1e-5}
# The ablations phase (models/ablations.py, the DCT switches, the native
# unwrap, the reference's checkpoints): TrivialSolutionNet at its one width
# on golden batch ABLATION_GOLDEN tiled to ABLATION_BATCH, the border ring
# launched once a reflect conv (REFLECT_CONVS) with the cuda backend, the
# cuda and matpad forwards and the card against the CPU held by the slice
# phase's SLICE_* rules (compare_ablation); HoloAutoEncoder at its full
# widths on the card at ABLATION_AE_BATCH, its instance-norm forward at B = 1
# against the CPU within ABLATION_AE_TOL of max (cuDNN fp32, TF32 off); the
# unwraps of the refocused phase of the golden batch's outputs: the fft and
# the matmul DCT, and the card and the CPU, within UNWRAP_TOL of max before
# the snap; every run's snapped phase equal to the matmul's in highest in
# SLICE_PHASE_FRACTION of the pixels (a pixel whose least-squares value sits
# at a half cycle may snap either way). high's error before the snap is
# printed, not bounded: the seeded net's phase is noise-like, and the Poisson
# solve amplifies the three bf16 products' rounding in its lowest modes
# (1.06e-4 of max on the card, 5.8e-5 on the CPU's slightly other input); the
# snap absorbs it, which is what high is for. The reference's checkpoint
# files at full width from Generator seed REFERENCE_SEED through
# retrieval_step, card against CPU by compare_outputs.
ABLATION_GOLDEN = 10
ABLATION_BATCH = 32
ABLATION_AE_BATCH = 8
ABLATION_AE_TOL = 1e-4
UNWRAP_TOL = 1e-4
REFERENCE_SEED = 1
# The reference's `net.vgg` up to relu4_1 (its stem RGB) and `net.decoder`
# as (Sequential index, C_out, C_in, k), the transposed convs (C_in, C_out,
# 2, 2); the distance MLP's Linear layers (out, in).
REFERENCE_VGG = ((0, 3, 3, 1), (2, 64, 3, 3), (5, 64, 64, 3), (9, 128, 64, 3), (12, 128, 128, 3),
                 (16, 256, 128, 3), (19, 256, 256, 3), (22, 256, 256, 3), (25, 256, 256, 3), (29, 512, 256, 3))
REFERENCE_DECODER = ((1, 512, 512, 3), (4, 256, 512, 3), (6, 256, 256, 2), (9, 256, 256, 3), (12, 256, 256, 3),
                     (15, 256, 256, 3), (18, 128, 256, 3), (20, 128, 128, 2), (23, 128, 128, 3),
                     (26, 64, 128, 3), (28, 64, 64, 2), (31, 64, 64, 3), (34, 64, 64, 3), (37, 2, 64, 3))
REFERENCE_TRANSPOSED = (6, 20, 28)
REFERENCE_DISTANCE = {"l1": (1024, 1024), "l2": (1024, 1024), "l3": (512, 1024), "out": (1, 512)}
# Peaks by card (NVIDIA data sheets, dense): fp32 FLOP/s outside the tensor
# cores, bf16 FLOP/s on the tensor cores, bytes/s.
PEAKS = {
    "H100 PCIe": (51.2e12, 756e12, 2.0e12),
    "H100 NVL": (60.0e12, 835e12, 3.9e12),
    "H100": (67.0e12, 989e12, 3.35e12),
}
# Real products per product of the DFT, and the rate's type, by precision
# mode: `highest` multiplies fp32 operands; `high` does each product as three
# products of bf16-rounded operands with fp32 accumulation (hi*hi + hi*lo +
# lo*hi), `bf16` as one, which the card's tensor cores run at the bf16 rate.
PRODUCTS = {"highest": (1, "fp32"), "high": (3, "bf16"), "bf16": (1, "bf16")}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


# Subprocesses of the run (the export phase's cold starts), stopped on the
# way out.
_CHILDREN: list = []


def _die(message: str, code: int) -> None:
    print(message, file=sys.stderr, flush=True)
    emit({"error": message})
    _build.kill_build()
    for child in _CHILDREN:
        child.kill()
    # the ranks of a world the parallel phase spawned (parallel.launch)
    for child in multiprocessing.active_children():
        child.kill()
    os._exit(code)


class Phase:
    """A phase under a wall-clock budget: overrunning it, or the whole run's,
    ends the process with exit code 3 and a line naming the phase."""

    def __init__(self, name: str):
        self.name = name
        self.info: dict = {}

    def __enter__(self):
        left = TOTAL_BUDGET_S - (time.monotonic() - _t_start)
        budget = min(BUDGETS_S[self.name], left)
        self._timer = threading.Timer(
            max(budget, 0.0),
            _die,
            args=(f"phase {self.name!r} overran its budget of {budget:.0f} s", 3),
        )
        self._timer.daemon = True
        self._timer.start()
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._timer.cancel()
        if exc_type is not None:
            return False
        emit({"phase": self.name, "seconds": round(time.monotonic() - self._t0, 3), **self.info})
        return False


def _dt(dtype) -> str:
    return str(dtype).replace("torch.", "")


def rel_err(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


def bf16_ulp(ref) -> float:
    """bf16's spacing at max|ref|, 2^(floor(log2 max|ref|) - 7)."""
    return 2.0 ** (math.floor(math.log2(float(ref.abs().max()))) - 7)


def random_planes(b: int, seed: int, device):
    g = torch.Generator().manual_seed(seed)
    xre = torch.rand(b, IMAGE, IMAGE, generator=g).to(device)
    xim = torch.rand(b, IMAGE, IMAGE, generator=g).to(device)
    return xre, xim


def spread_distances(b: int, device):
    """Per-sample refocus distances over the suite's range, both signs (m)."""
    return torch.linspace(-0.8e-3, 0.8e-3, b, dtype=torch.float32).to(device)


@torch.no_grad()
def seeded_weights_(net: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Fill every weight from ``torch.Generator`` seed ``seed``: He-normal
    kernels (std sqrt(2 / fan_in), so activations keep their scale through
    the ReLU stack) and N(0, 0.01^2) biases. The release's own weights are
    orbax files that this machine cannot read."""
    g = torch.Generator().manual_seed(seed)
    for module in net.modules():
        if not isinstance(module, (torch.nn.Conv1d, torch.nn.Conv2d, torch.nn.Linear, ConvTranspose2x2)):
            continue
        w = module.weight
        # a transposed conv's output sums C_in taps; the others sum a row of w
        fan_in = w.shape[0] if isinstance(module, ConvTranspose2x2) else w[0].numel()
        w.copy_(torch.randn(w.shape, generator=g) * (2.0 / fan_in) ** 0.5)
        if module.bias is not None:
            module.bias.copy_(0.01 * torch.randn(module.bias.shape, generator=g))
    return net


def phase_device():
    if not torch.cuda.is_available():
        print("no CUDA device: this script measures the port on a card", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip().splitlines()[0]
    return smi


def check_odd_shapes(kw, device):
    """Both ASM kernels against their plain versions at ODD_SHAPES, in every
    precision mode (the tensor-core tiles' ragged edges)."""
    rows = []
    for b, h, w in ODD_SHAPES:
        g = torch.Generator().manual_seed(h + w)
        xre = torch.rand(b, h, w, generator=g).to(device)
        xim = torch.rand(b, h, w, generator=g).to(device)
        dist = spread_distances(b, device)
        for prec, tol in TOLERANCES.items():
            for name, run, plain, d in (
                ("asm_const", asm_cuda.asm_const, asm_cuda.asm_const_plain, SERVING_REFOCUS_M),
                ("asm_dynamic", asm_cuda.asm_dynamic, asm_cuda.asm_dynamic_plain, dist),
            ):
                y = torch.complex(*run(xre, xim, d, precision=prec, **kw))
                p = torch.complex(*plain(xre, xim, d, precision=prec, **kw))
                torch.cuda.synchronize()
                row = {"kernel": name, "shape": [b, h, w], "precision": prec, "tol": tol,
                       "max_abs_err": float((y - p).abs().max()), "rel_err_vs_plain": rel_err(y, p)}
                rows.append(row)
                if not row["rel_err_vs_plain"] < tol:
                    _die(f"kernel check failed: {json.dumps(row)}", 1)
    return rows


def check_kernels(physics, device, batches=(5, 256)):
    """Each kernel against its plain version and the torch.fft composition,
    at B = 5 and 256 on 128^2, then at ODD_SHAPES against the plain version."""
    kw = dict(wavelength=physics.wavelength, pixel_size=physics.pixel_size)
    rows = check_odd_shapes(kw, device)
    for b in batches:
        xre, xim = random_planes(b, seed=b, device=device)
        field = torch.complex(xre, xim)
        dist = spread_distances(b, device)
        fft_const = propagate_torch(field, SERVING_REFOCUS_M, **kw)
        fft_dyn = propagate_torch(field, dist.reshape(b, 1, 1), **kw)
        for prec, tol in TOLERANCES.items():
            for name, run, run_plain, fft in (
                ("asm_const",
                 lambda: asm_cuda.asm_const(xre, xim, SERVING_REFOCUS_M, precision=prec, **kw),
                 lambda: asm_cuda.asm_const_plain(xre, xim, SERVING_REFOCUS_M, precision=prec, **kw),
                 fft_const),
                ("asm_dynamic",
                 lambda: asm_cuda.asm_dynamic(xre, xim, dist, precision=prec, **kw),
                 lambda: asm_cuda.asm_dynamic_plain(xre, xim, dist, precision=prec, **kw),
                 fft_dyn),
            ):
                y = torch.complex(*run())
                p = torch.complex(*run_plain())
                torch.cuda.synchronize()
                row = {
                    "kernel": name, "B": b, "shape": [b, IMAGE, IMAGE], "precision": prec, "tol": tol,
                    "max_abs_err": float((y - p).abs().max()),
                    "rel_err_vs_plain": rel_err(y, p),
                    "rel_err_vs_fft": rel_err(y, fft),
                }
                rows.append(row)
                if not (row["rel_err_vs_plain"] < tol and row["rel_err_vs_fft"] < tol):
                    _die(f"kernel check failed: {json.dumps(row)}", 1)
    return rows


def drive_slice(net, goldens, cfg, device):
    """The main path: the whole golden suite, then one batch with per-sample
    style distances. Returns (metrics, per-sample output)."""
    metrics = evaluate_golden_suite(net, goldens, cfg, device=device)
    d_style = goldens.distance_style[0] * (1.0 + 0.05 * np.arange(goldens.batch_size)).reshape(-1, 1, 1, 1)
    out = retrieval_step(
        net, goldens.content_holo[0], goldens.style_mean, goldens.style_std,
        d_style.astype(np.float32), cfg.physics, device=device,
    )
    return metrics, out


def check_slice_outputs(metrics, out, b: int):
    for key in ("mean_psnr", "mean_mae", "r2", "heldout_mean_psnr"):
        if not math.isfinite(metrics[key]):
            _die(f"slice metric {key} is not finite: {metrics[key]}", 1)
    if len(metrics["psnr_per_batch"]) != 20 or len(metrics["distance_pred_um"]) != 100:
        _die("slice metrics do not cover the 20 x 5 suite", 1)
    shapes = {"amp_field": (b, 1, IMAGE, IMAGE), "ph_field": (b, 1, IMAGE, IMAGE),
              "amp_foc": (b, 1, IMAGE, IMAGE), "ph_foc": (b, 1, IMAGE, IMAGE),
              "distance_pred": (b, 1, 1, 1)}
    for key, shape in shapes.items():
        t = out[key]
        if tuple(t.shape) != shape or not bool(torch.isfinite(t).all()):
            _die(f"slice output {key}: shape {tuple(t.shape)} (want {shape}) or non-finite", 1)


def compare_card_cpu(net, goldens, cfg, batch: int):
    """One golden batch on the card against the same port on the CPU."""
    net_cpu = copy.deepcopy(net).cpu()
    args = (goldens.content_holo[batch], goldens.style_mean, goldens.style_std,
            float(goldens.distance_style[batch].reshape(-1)[0]), cfg.physics)
    gpu = retrieval_step(net, *args, device="cuda")
    cpu = retrieval_step(net_cpu, *args, device="cpu")
    return {"batch": batch, **compare_outputs(
        gpu, cpu, SLICE_AMP_TOL, SLICE_DIST_TOL, SLICE_PHASE_TOL, SLICE_PHASE_FRACTION,
        "card and CPU on the slice")}


def _grads_of(fn, xre, xim, dist, weights):
    """Gradients of a real loss, nonlinear in (yre, yim), for xre, xim and
    a tensor ``dist``."""
    inputs = [xre.clone().requires_grad_(), xim.clone().requires_grad_()]
    if isinstance(dist, torch.Tensor):
        inputs.append(dist.clone().requires_grad_())
    yre, yim = fn(*inputs)
    loss = (weights[0] * yre + weights[1] * yim * yim + 0.3 * (yre * yre + yim * yim) ** 2).sum()
    return torch.autograd.grad(loss, inputs)


def check_function_grads(physics, device, batches=(5, 256)):
    """The asm_const op's field gradient and the asm_dynamic op's field and
    distance gradients against propagate_torch autograd on the card."""
    kw = dict(wavelength=physics.wavelength, pixel_size=physics.pixel_size)
    rows = []
    for b in batches:
        xre, xim = random_planes(b, seed=b + 1, device=device)
        g = torch.Generator().manual_seed(b + 2)
        weights = torch.randn(2, b, IMAGE, IMAGE, generator=g).to(device)
        dist = spread_distances(b, device)

        def fft(xre, xim, d=SERVING_REFOCUS_M):
            y = propagate_torch(torch.complex(xre, xim), d.reshape(-1, 1, 1) if isinstance(
                d, torch.Tensor) else d, **kw)
            return y.real, y.imag

        for prec in ("high", "highest"):
            for name, fn, d in (
                ("asm_const", lambda xr, xi, p=prec: asm_cuda.asm_const(
                    xr, xi, SERVING_REFOCUS_M, precision=p, **kw), None),
                ("asm_dynamic", lambda xr, xi, dd, p=prec: asm_cuda.asm_dynamic(
                    xr, xi, dd, precision=p, **kw), dist),
            ):
                got = _grads_of(fn, xre, xim, d, weights)
                ref = _grads_of(fft, xre, xim, d, weights)
                torch.cuda.synchronize()
                errs = [rel_err(a, r) for a, r in zip(got, ref)]
                row = {"function": name, "B": b, "precision": prec, "tol": GRAD_TOL,
                       "rel_err_field": max(errs[:2]),
                       "rel_err_distance": errs[2] if len(errs) > 2 else None}
                rows.append(row)
                if not max(errs) < GRAD_TOL or not all(float(r.abs().max()) > 0 for r in ref):
                    _die(f"gradient check failed: {json.dumps(row)}", 1)
    return rows


def noisy_golden_batch(goldens, b=None, seed=0):
    """Golden batch REFINE_BATCH's (amplitude, GT phase plus REFINE_NOISE_RAD
    of numpy-seeded noise, true distances, sqrt hologram, GT phase); with
    ``b``, the whole suite's samples tiled to b images instead."""
    if b is None:
        gt, d, holo = (goldens.gt_phase[REFINE_BATCH], goldens.distance_content[REFINE_BATCH],
                       goldens.content_holo[REFINE_BATCH])
    else:
        idx = np.arange(b) % (goldens.n_batches * goldens.batch_size)
        gt = goldens.gt_phase.reshape(-1, 1, IMAGE, IMAGE)[idx]
        d = goldens.distance_content.reshape(-1, 1, 1, 1)[idx]
        holo = goldens.content_holo.reshape(-1, 1, IMAGE, IMAGE)[idx]
    rng = np.random.default_rng(seed)
    ph0 = (gt + REFINE_NOISE_RAD * rng.standard_normal(gt.shape)).astype(np.float32)
    return np.full_like(gt, 0.6), ph0, d, np.sqrt(holo), gt


def refined_psnr(out, gt) -> float:
    return float(psnr(zero_mean(out["phase"].cpu()), zero_mean(torch.as_tensor(gt))))


def refine_card_vs_cpu(goldens, physics, device):
    """The physics-anchored refine on the card and on the CPU; the card's
    asm_dynamic launches of its run."""
    amp, ph0, d, meas, gt = noisy_golden_batch(goldens)
    kw = dict(steps=REFINE_STEPS, optimize_amp=False)
    asm_cuda.reset_launches()
    card = physics_refine(amp, ph0, d, meas, physics, device=device, **kw)
    torch.cuda.synchronize()
    launches = asm_cuda.LAUNCHES["asm_dynamic"]
    cpu = physics_refine(amp, ph0, d, meas, physics, device="cpu", **kw)
    row = {"batch": REFINE_BATCH, "steps": REFINE_STEPS, "noise_rad": REFINE_NOISE_RAD,
           "card_psnr_db": refined_psnr(card, gt), "cpu_psnr_db": refined_psnr(cpu, gt),
           "start_psnr_db": refined_psnr({"phase": torch.as_tensor(ph0)}, gt),
           "card_residual_mean": float(card["residual"].mean()),
           "cpu_residual_mean": float(cpu["residual"].mean()),
           "asm_dynamic_launches": launches, "tol_db": REFINE_DB_TOL}
    if not abs(row["card_psnr_db"] - row["cpu_psnr_db"]) < REFINE_DB_TOL or launches != REFINE_STEPS + 1:
        _die(f"refine on the card and the CPU part: {json.dumps(row)}", 1)
    return row


def _timed_refine(amp, ph0, d, meas, physics, backend, kw) -> float:
    """ms of one physics_refine by CUDA events, the launch counts reset
    just before it."""
    asm_cuda.reset_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    physics_refine(amp, ph0, d, meas, physics, asm_backend=backend, **kw)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def time_refine(goldens, physics, device, b: int = B_TIMING):
    """One refine of b images at 128^2, REFINE_STEPS steps, its wall time by
    CUDA events, through the kernels (``auto``) and through torch.fft alone
    (``torch``): REFINE_PAIRS pairs, which path runs first alternating, each
    path's median and quartiles, and the pairs the kernel path won; then at
    the same shapes the forward kernel (asm_dynamic) and the op's
    backward (the adjoint) alone, and torch autograd's backward of
    ``propagate_torch``, each a median of CUDA-event times; the rest of a
    step is what neither takes."""
    amp, ph0, d, meas, _ = (torch.as_tensor(a, device=device) for a in noisy_golden_batch(goldens, b))
    kw = dict(steps=REFINE_STEPS, optimize_amp=False, device=device)
    runs = {"auto": [], "torch": []}
    launches = {}
    for backend in ("auto", "torch"):  # warm-up
        physics_refine(amp, ph0, d, meas, physics, asm_backend=backend, **dict(kw, steps=2))
    for i in range(REFINE_PAIRS):
        order = ("auto", "torch") if i % 2 == 0 else ("torch", "auto")
        for backend in order:
            runs[backend].append(_timed_refine(amp, ph0, d, meas, physics, backend, kw))
            launches.setdefault(backend, set()).add(asm_cuda.LAUNCHES["asm_dynamic"])
    if launches != {"auto": {REFINE_STEPS + 1}, "torch": {0}}:
        _die(f"timed refines launched asm_dynamic {launches} times, want "
             f"{{'auto': {REFINE_STEPS + 1}, 'torch': 0}} a run", 1)
    total_ms = float(np.median(runs["auto"]))
    torch_total_ms = float(np.median(runs["torch"]))
    wins = sum(a < t for a, t in zip(runs["auto"], runs["torch"]))

    xre = (amp * torch.cos(ph0)).reshape(b, IMAGE, IMAGE).contiguous()
    xim = (amp * torch.sin(ph0)).reshape(b, IMAGE, IMAGE).contiguous()
    dist = physics.to_metres(d).reshape(b).contiguous()
    okw = dict(wavelength=physics.wavelength, pixel_size=physics.pixel_size)
    fwd_ms = median_ms(lambda: asm_cuda.asm_dynamic(xre, xim, dist, **okw))
    xr, xi = xre.clone().requires_grad_(), xim.clone().requires_grad_()
    yre, yim = asm_cuda.asm_dynamic(xr, xi, dist, **okw)
    gre, gim = torch.randn_like(yre), torch.randn_like(yim)
    bwd_ms = median_ms(lambda: torch.autograd.grad((yre, yim), (xr, xi), (gre, gim), retain_graph=True))
    y = propagate_torch(torch.complex(xr, xi), dist.reshape(b, 1, 1), **okw)
    torch_bwd_ms = median_ms(
        lambda: torch.autograd.grad((y.real, y.imag), (xr, xi), (gre, gim), retain_graph=True))
    step_ms = total_ms / REFINE_STEPS
    fwd_step = fwd_ms * (REFINE_STEPS + 1) / REFINE_STEPS
    return {
        "B": b, "steps": REFINE_STEPS, "asm_dynamic_launches": REFINE_STEPS + 1, "pairs": REFINE_PAIRS,
        "total_ms": total_ms, "total_ms_quartiles": np.percentile(runs["auto"], [25, 75]).tolist(),
        "total_ms_runs": runs["auto"], "step_ms": step_ms,
        "torch_backend_total_ms": torch_total_ms,
        "torch_backend_total_ms_quartiles": np.percentile(runs["torch"], [25, 75]).tolist(),
        "torch_backend_total_ms_runs": runs["torch"], "kernel_path_wins": wins,
        "torch_backend_step_ms": torch_total_ms / REFINE_STEPS,
        "step_ms_saved_by_kernel": (torch_total_ms - total_ms) / REFINE_STEPS,
        "forward_kernel_ms_standalone": fwd_ms, "backward_ms_standalone": bwd_ms,
        "torch_autograd_backward_ms_standalone": torch_bwd_ms,
        "forward_kernel_share": fwd_step / step_ms, "backward_share": bwd_ms / step_ms,
        "rest_ms_per_step": step_ms - fwd_step - bwd_ms,
        "holograms_per_s": b / total_ms * 1e3,
    }


HEAD_WIDTHS = (64, 64)      # conv1_1 on the folded one-channel stem, conv1_2
TAIL_WIDTHS = halo_exp.TAIL_WIDTHS  # conv8, conv9, conv10
# The halo tail: block heights of scripts/exp_halo_conv.py, and the tail's
# input widths of the flagship (64) and the `ultra` release (16).
HALO_BH = (30, 60)
HALO_WIDTHS = (64, 16)
HALO_KERNELS = {"halo_conv_tail": halo_conv.halo_conv_tail,
                "halo_conv_tail_static": halo_conv.halo_conv_tail_static}
# Each kernel's row in scripts/port_exp_halo_conv.py.
HALO_ROWS = {"halo_conv_tail": "halo", "halo_conv_tail_static": "halo_static"}
HALO_OPS = {"halo_conv_tail": "halo_interior", "halo_conv_tail_static": "halo_interior_static"}
# bf16 ulps of max|ref| allowed where the strips' conv differs by device.
HALO_EDGE_ULPS = 4
# Ragged shapes (B, C, H, W) of the tail's tensor-core tiles: the widths of
# `turbo` (24), `balanced` (48) and `ultra` (16), H and W off the 16 x 16
# tile (the tail takes H and W even); and 80 channels (a width-1.25 net),
# where the bf16 tail runs the SIMT body.
TAIL_ODD_SHAPES = ((2, 24, 32, 24), (2, 48, 20, 34), (1, 16, 20, 12), (1, 80, 20, 34))
# The head's: (B, C, width, H, W), one or three input channels, the
# releases' widths 16 (`ultra`), 24 (`turbo`), 32 (`fast`), 48
# (`balanced`), H and W off its 16 x 32 pre-pool tile; and width 80 (the
# SIMT body in bf16).
HEAD_ODD_SHAPES = ((2, 1, 16, 20, 34), (2, 3, 24, 34, 20), (2, 1, 32, 36, 40), (2, 1, 48, 128, 128),
                   (1, 3, 64, 20, 34), (1, 1, 80, 20, 34))
# The halo tail's: ((B, C, H, W), bh), W off the 16-column tile, the row
# tiles 12 and 16 rows high.
HALO_ODD_SHAPES = (((2, 24, 56, 34), 24), ((2, 48, 40, 20), 16))


def check_conv_kernels(device, batches=(5, 256)):
    """The stack kernels and the border ring against their plain versions."""
    rows = []
    cases = []
    for b, c, width, h, w in HEAD_ODD_SHAPES:
        for dtype in CONV_TOLERANCES:
            cases.append(("fused_encoder_head", b, dtype, (b, c, width, h, w),
                          lambda b=b, c=c, width=width, h=h, w=w, dt=dtype: seeded_stack(
                              b, dt, c, (width, width), b + c + width + h + w, device, size=(h, w)),
                          conv_stack.fused_encoder_head, conv_stack.encoder_head_plain))
    for shape in TAIL_ODD_SHAPES:
        for dtype in CONV_TOLERANCES:
            cases.append(("fused_conv_tail", shape[0], dtype, shape,
                          lambda shape=shape, dt=dtype: seeded_stack(
                              shape[0], dt, shape[1], (shape[1], shape[1], 2), sum(shape), device,
                              size=shape[2:]),
                          conv_stack.fused_conv_tail, conv_stack.conv_tail_plain))
    for b in batches:
        for dtype in CONV_TOLERANCES:
            cases.append(("fused_encoder_head", b, dtype, None,
                          lambda b=b, dt=dtype: seeded_stack(b, dt, 1, HEAD_WIDTHS, b, device),
                          conv_stack.fused_encoder_head, conv_stack.encoder_head_plain))
            cases.append(("fused_conv_tail", b, dtype, None,
                          lambda b=b, dt=dtype: seeded_stack(b, dt, 64, TAIL_WIDTHS, b, device),
                          conv_stack.fused_conv_tail, conv_stack.conv_tail_plain))
            for layer in RING_LAYERS:
                cases.append(("border_lines", b, dtype, layer,
                              lambda b=b, dt=dtype, layer=layer: ring_inputs(b, layer, b, device, dt),
                              reflect_border.border_lines, reflect_border.border_lines_plain))
    for name, b, dtype, layer, make, run, plain in cases:
        args = make()
        got, ref = run(*args), plain(*args)
        if name != "border_lines":
            got, ref = (got,), (ref,)
        torch.cuda.synchronize()
        err = max(float((g.float() - r.float()).abs().max()) for g, r in zip(got, ref))
        rel = max(rel_err(g.float(), r.float()) for g, r in zip(got, ref))
        row = {"kernel": name, "B": b, "dtype": _dt(dtype),
               "layer": layer, "tol": CONV_TOLERANCES[dtype],
               "max_abs_err": err, "rel_err_vs_plain": rel}
        rows.append(row)
        if not rel < CONV_TOLERANCES[dtype]:
            _die(f"kernel check failed: {json.dumps(row)}", 1)
        del args, got, ref
    return rows


def drive_halo(device):
    """The halo slice's path, as ``scripts/port_exp_halo_conv.py`` drives it:
    both entry points on one seeded flagship-width input at B = 256 in bf16,
    at each block height. Returns (args, outputs by kernel and bh)."""
    args = seeded_stack(B_TIMING, torch.bfloat16, 64, TAIL_WIDTHS, 3, device)
    outs = {(name, bh): fn(*args, bh=bh) for bh in HALO_BH for name, fn in HALO_KERNELS.items()}
    return args, outs


def check_halo_outputs(args, outs):
    """Finite outputs of the tail's shape that agree with the plain version
    on the first images."""
    b = args[0].shape[0]
    head = [a[:2] if i == 0 else a for i, a in enumerate(args)]
    for (name, bh), y in outs.items():
        if tuple(y.shape) != (b, 2, IMAGE, IMAGE) or not bool(torch.isfinite(y).all()):
            _die(f"halo output of {name} at bh {bh}: shape {tuple(y.shape)} or non-finite", 1)
        ref = halo_conv.halo_conv_tail_plain(*head, bh=bh).float()
        if not rel_err(y[:2].float(), ref) < CONV_TOLERANCES[torch.bfloat16]:
            _die(f"halo output of {name} at bh {bh} disagrees with the plain version", 1)


def check_halo_kernels(device, batches=(5, 256)):
    """Both halo kernels against ``halo_conv_tail_plain``, and their interior
    rows against ``fused_conv_tail`` on the same input: bit for bit in bf16
    (one tile body, one summation order a pixel), within the tolerance in
    fp32. At B = 5 and 256 on the flagship's square images, then at
    ``HALO_ODD_SHAPES``."""
    edge = halo_conv.EDGE
    rows = []
    cases = [((b, c, IMAGE, IMAGE), dtype, HALO_BH)
             for b in batches for dtype in CONV_TOLERANCES for c in HALO_WIDTHS]
    cases += [(shape, dtype, (bh,)) for shape, bh in HALO_ODD_SHAPES for dtype in CONV_TOLERANCES]
    for (b, c, h, w), dtype, bhs in cases:
        seed = b + c if (h, w) == (IMAGE, IMAGE) else b + c + h + w
        args = seeded_stack(b, dtype, c, (c, c, 2), seed, device, size=(h, w))
        tol = CONV_TOLERANCES[dtype]
        fused = conv_stack.fused_conv_tail(*args)[:, :, edge:-edge]
        for bh in bhs:
            plain = halo_conv.halo_conv_tail_plain(*args, bh=bh).float()
            for name, fn in HALO_KERNELS.items():
                got = fn(*args, bh=bh)
                torch.cuda.synchronize()
                inner = got[:, :, edge:-edge]
                row = {"kernel": name, "B": b, "dtype": _dt(dtype), "C": c, "bh": bh,
                       "shape": list(args[0].shape), "tol": tol,
                       "max_abs_err": float((got.float() - plain).abs().max()),
                       "rel_err_vs_plain": rel_err(got.float(), plain),
                       "interior_rel_err_vs_fused_tail": rel_err(inner.float(), fused.float()),
                       "interior_equals_fused_tail": bool(torch.equal(inner, fused))}
                rows.append(row)
                inner_ok = (row["interior_equals_fused_tail"] if dtype == torch.bfloat16
                            else row["interior_rel_err_vs_fused_tail"] < tol)
                if not (row["rel_err_vs_plain"] < tol and inner_ok):
                    _die(f"halo kernel check failed: {json.dumps(row)}", 1)
                del got, inner
            del plain
        del args, fused
    return rows


def check_halo_card_vs_cpu(device, b: int = 2, bh: int = HALO_BH[0]):
    """Both halo kernels and ``conv_tail_reference`` on the card against the
    port's CPU versions on the same inputs, which tests/test_torch_halo_conv.py
    holds to the JAX package. On the card the strips are cuDNN's convs in
    x's dtype, on the CPU fp32 convs rounded once; each then rounds the bias
    add. fp32: CONV_TOLERANCES throughout. bf16: the interior rows within
    CONV_TOLERANCES, the 4 + 4 edge rows and the whole reference within
    HALO_EDGE_ULPS bf16 ulps of max|ref| (the CPU tests' edge budget)."""
    edge = halo_conv.EDGE
    rows = []
    for dtype, tol in CONV_TOLERANCES.items():
        for c in HALO_WIDTHS:
            args = seeded_stack(b, dtype, c, (c, c, 2), 7 + c, device)
            cpu_args = [t.cpu() for t in args]
            plain = halo_conv.halo_conv_tail_plain(*cpu_args, bh=bh).float()
            ref = conv_stack.conv_tail_reference(*cpu_args).float()
            card_ref = conv_stack.conv_tail_reference(*args).float().cpu()
            row = {"B": b, "dtype": _dt(dtype), "C": c, "bh": bh, "tol": tol,
                   "edge_ulps_budget": HALO_EDGE_ULPS,
                   "reference_ulps": float((card_ref - ref).abs().max()) / bf16_ulp(ref),
                   "reference_rel_err": rel_err(card_ref, ref)}
            ok = (row["reference_ulps"] <= HALO_EDGE_ULPS if dtype == torch.bfloat16
                  else row["reference_rel_err"] < tol)
            for name, fn in HALO_KERNELS.items():
                got = fn(*args, bh=bh).float().cpu()
                inner, outer = got[:, :, edge:-edge], torch.cat([got[:, :, :edge], got[:, :, -edge:]], 2)
                p_inner = plain[:, :, edge:-edge]
                p_outer = torch.cat([plain[:, :, :edge], plain[:, :, -edge:]], 2)
                row[name] = {"interior_rel_err": rel_err(inner, p_inner),
                             "edge_rel_err": float((outer - p_outer).abs().max() / plain.abs().max()),
                             "edge_ulps": float((outer - p_outer).abs().max()) / bf16_ulp(plain)}
                ok = ok and row[name]["interior_rel_err"] < tol and (
                    row[name]["edge_ulps"] <= HALO_EDGE_ULPS if dtype == torch.bfloat16
                    else row[name]["edge_rel_err"] < tol)
            rows.append(row)
            if not ok:
                _die(f"halo tail on the card and the CPU disagree: {json.dumps(row)}", 1)
    return rows


def halo_bounds(peak_flops, peak_bytes, b: int):
    """Least time (ms) and what bounds it, by dtype, for the halo tail at
    flagship width: ``function`` is the entry point's function, the tail on
    all H rows (x read once, the output written once; the same as the fused
    tail's bound), ``interior`` the kernel's work alone (rows 4..H-5,
    reading input rows 1..H-2)."""
    macs_px = 9 * (64 * 64 + 64 * 64 + 64 * 2)
    h = w = IMAGE
    edge = halo_conv.EDGE
    out = {}
    for dtype, kind in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        size = 2 if dtype == torch.bfloat16 else 4
        weights = macs_px * size + 130 * 4
        for part, rows, in_rows in (("interior", h - 2 * edge, h - 2), ("function", h, h)):
            t_ops = 2 * macs_px * rows * w * b / peak_flops[kind] * 1e3
            t_bytes = ((64 * in_rows + 2 * rows) * w * size * b + weights) / peak_bytes * 1e3
            out[part, dtype] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
    return out


def time_halo(device):
    """CUDA-event medians at B = 256, by dtype: the rows of
    ``scripts/port_exp_halo_conv.py`` (its ``xla_tail``, the port's
    ``conv_tail_reference``, is the cuDNN composition of the tail), each
    kernel's launch alone, and the plain versions."""
    out = {}
    for dtype in CONV_TOLERANCES:
        a = seeded_stack(B_TIMING, dtype, 64, TAIL_WIDTHS, 2, device)
        t = {name: median_ms(fn, reps=7) for name, fn in halo_exp.rows(a, HALO_BH).items()}
        for bh in HALO_BH:
            for row, static in (("halo", False), ("halo_static", True)):
                t[f"{row}_interior_bh{bh}"] = median_ms(lambda: halo_conv.halo_interior(
                    *a, bh=bh, static=static), reps=7)
            t[f"plain_bh{bh}"] = median_ms(lambda: halo_conv.halo_conv_tail_plain(*a, bh=bh),
                                           reps=3, warmup=1)
            t[f"plain_interior_bh{bh}"] = median_ms(
                lambda: halo_conv.halo_interior_plain(*a, bh=bh), reps=3, warmup=1)
        out[_dt(dtype)] = t
        del a
    return out


def compare_outputs(got, ref, amp_tol, dist_tol, phase_tol, phase_fraction, label):
    """Two retrieval outputs of one batch: amp_foc relative to max|ref|,
    distance_pred absolute, the zero-meaned phase modulo 2 pi."""
    amp_err = rel_err(got["amp_foc"].cpu(), ref["amp_foc"].cpu())
    dist_err = float((got["distance_pred"].cpu() - ref["distance_pred"].cpu()).abs().max())
    dph = zero_mean(got["ph_foc"].cpu()) - zero_mean(ref["ph_foc"].cpu())
    wrapped = torch.remainder(dph - dph.flatten()[0] + math.pi, 2 * math.pi) - math.pi
    ok_frac = float((wrapped.abs() < phase_tol).float().mean())
    jumps = int(((dph.abs() > phase_tol) & (wrapped.abs() < phase_tol)).sum())
    result = {
        "amp_foc_rel_err": amp_err, "amp_tol": amp_tol,
        "distance_pred_abs_err": dist_err, "distance_tol": dist_tol,
        "ph_foc_frac_within_tol_mod_2pi": ok_frac, "phase_tol": phase_tol,
        "phase_fraction": phase_fraction, "ph_foc_2pi_jumps": jumps,
    }
    if not (amp_err < amp_tol and dist_err < dist_tol and ok_frac >= phase_fraction):
        _die(f"{label} disagree: {json.dumps(result)}", 1)
    return result


def _cpu(v):
    return v.cpu() if torch.is_tensor(v) else v


def _one_int8_step(x, act_max):
    """``x`` with one zero activation (after the relu; the middle one in
    memory order) set to one int8 step, act_max / 127: its quantized value
    goes from 0 to 1 and nothing else moves."""
    flat = x.clone().reshape(-1)
    zeros = (flat == 0).nonzero().reshape(-1)
    if zeros.numel() == 0:
        _die("the first int8 conv's input has no zero to move by one step", 1)
    flat[zeros[zeros.numel() // 2]] = float(act_max) / 127.0
    return flat.reshape(x.shape)


def run_recorded(net, args, scales, dt, device, one_step=False):
    """``retrieval_step`` on the int8 path with every call of QUANT_OPS
    recorded as (op, args, kwargs, output); ``one_step`` moves one activation
    of the first int8 conv's input by one int8 step."""
    calls = []
    real = {op: getattr(quant, op) for op in QUANT_OPS}

    def recording(op):
        def call(*a, **kw):
            if one_step and op == "int8_conv_valid" and not any(c[0] == op for c in calls):
                a = (_one_int8_step(a[0], kw["act_max"]),) + a[1:]
            y = real[op](*a, **kw)
            calls.append((op, a, kw, y))
            return y
        return call

    for op in QUANT_OPS:
        setattr(quant, op, recording(op))
    try:
        out = retrieval_step(net, *args, quant_scales=scales, dtype=dt, device=device)
    finally:
        for op, fn in real.items():
            setattr(quant, op, fn)
    return out, calls


@torch.inference_mode()
def ops_on_cpu(calls, dt):
    """Each recorded call again on the CPU from the same inputs (the stack
    wrappers take their plain versions there). Returns, by op, the calls
    and the largest max|err| / max|ref|."""
    worst = {}
    for op, a, kw, y in calls:
        ref = getattr(quant, op)(*map(_cpu, a), **{k: _cpu(v) for k, v in kw.items()}).float()
        err = float((y.cpu().float() - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
        n, e = worst.get(op, (0, 0.0))
        worst[op] = (n + 1, max(e, err))
    return {op: {"calls": n, "rel_err": e} for op, (n, e) in worst.items()}


def divergence(calls, calls_ref):
    """Where two runs of the path part, call by call: the inputs' max|diff|
    / max|ref| and, at an int8 conv, how many quantized activations differ."""
    if [c[0] for c in calls] != [c[0] for c in calls_ref]:
        _die("two runs of the int8 path called different ops", 1)
    rows = []
    for (op, a, kw, _), (_, a_ref, _, _) in zip(calls, calls_ref):
        i = 1 if op == "conv_in_dtype" else 0  # conv_in_dtype(op, x, kernel, bias, dt)
        x, x_ref = a[i].cpu().float(), a_ref[i].cpu().float()
        row = {"op": op, "input_rel_diff": rel_err(x, x_ref)}
        if op == "int8_conv_valid":
            sx = torch.tensor(127.0) / torch.clamp(kw["act_max"].float().cpu(), min=1e-8)
            row["int8_steps_differ"] = int((quant._quantize(x, sx) != quant._quantize(x_ref, sx)).sum())
        rows.append(row)
    return rows


def output_diffs(got, ref):
    """amp_foc's max|err| / max|ref| and ||err|| / ||ref||, distance_pred's
    max|err|."""
    amp, amp_ref = got["amp_foc"].cpu(), ref["amp_foc"].cpu()
    return {
        "amp_foc_rel_err": rel_err(amp, amp_ref),
        "amp_foc_rel_l2": float((amp - amp_ref).norm() / amp_ref.norm()),
        "distance_pred_abs_err": float((got["distance_pred"].cpu() - ref["distance_pred"].cpu()).abs().max()),
    }


def int8_path_card_vs_cpu(net, net_cpu, args, scales, dt):
    """One golden batch of the int8 path on the card against the same port
    on the CPU: every op of the card's run again on the CPU from the same
    inputs, where the two runs part, what one int8 step moves, and the
    outputs."""
    got, calls = run_recorded(net, args, scales, dt, "cuda")
    ref, calls_ref = run_recorded(net_cpu, args, scales, dt, "cpu")
    stepped, calls_stepped = run_recorded(net, args, scales, dt, "cuda", one_step=True)
    ops = ops_on_cpu(calls, dt)
    trace = divergence(calls, calls_ref)
    result = {
        "ops_same_inputs": ops, "op_tol": CONV_TOLERANCES[dt],
        "card_vs_cpu_by_call": trace,
        "card_vs_cpu": output_diffs(got, ref),
        "one_int8_step": {
            "int8_steps_differ": divergence(calls_stepped, calls)[next(
                i for i, c in enumerate(calls) if c[0] == "int8_conv_valid")]["int8_steps_differ"],
            **output_diffs(stepped, got),
        },
        "tol": QUANT_PATH_TOL[dt],
    }
    held = (
        ops["int8_conv_valid"]["calls"] > 0 and ops["int8_conv_valid"]["rel_err"] == 0.0
        and all(v["rel_err"] < CONV_TOLERANCES[dt] for k, v in ops.items() if k != "int8_conv_valid")
        and result["one_int8_step"]["int8_steps_differ"] == 1
        and all(result["card_vs_cpu"][k] < t for k, t in QUANT_PATH_TOL[dt].items())
    )
    if not held:
        _die(f"int8 path ({_dt(dt)}) on the card and the CPU disagree: {json.dumps(result)}", 1)
    return result


def load_fast(device):
    """The ``fast`` release on the card: (net, config, style vector, int8
    scales, records by path). A missing file raises: the weights are
    committed."""
    with open(os.path.join(FAST, "config.json")) as f:
        cfg = ExperimentConfig.from_json(f.read())
    state = load_release_weights(os.path.join(FAST, "torch_weights.npz"))
    net = StyleTransferNet.from_state_dict(state, cfg.model.width).to(device)
    style = load_style_vector(os.path.join(FAST, "style_vector.npz"))
    scales = quant.load_scales(os.path.join(FAST, "quant_scales.json"))
    records = {}
    for path, name in (("fp32", "golden_metrics.json"), ("int8", "quant_golden_metrics.json"),
                       ("bf16", "bf16_golden_metrics.json")):
        with open(os.path.join(FAST, name)) as f:
            records[path] = json.load(f)
    return net, cfg, style, scales, records


def suite_rule(metrics, record):
    """The int8 rule: mean PSNR within SUITE_DB and R² within SUITE_R2 of
    the record."""
    d_db = metrics["mean_psnr"] - record["mean_psnr"]
    d_r2 = metrics["r2"] - record["r2"]
    return {"mean_psnr": metrics["mean_psnr"], "record_mean_psnr": record["mean_psnr"],
            "r2": metrics["r2"], "record_r2": record["r2"],
            "heldout_mean_psnr": metrics["heldout_mean_psnr"],
            "mean_psnr_diff_db": d_db, "r2_diff": d_r2,
            "held": abs(d_db) < SUITE_DB and abs(d_r2) < SUITE_R2}


GOLDEN_PATHS = ("fp32", "int8_stacks_off", "int8_stacks_on", "refined", "bf16")


def run_golden(net, goldens, cfg, style, scales, records, device, paths=GOLDEN_PATHS, fp32_reading=None):
    """``paths`` of the release (``GOLDEN_PATHS``, every one by default) over
    the suite on the card, each against its record (the bf16 path only where
    the release has a bf16 record; int8 with the stacks on printed beside
    the stacks off). fp32 every batch within GOLDEN_BATCH_DB of the record,
    and every batch within GOLDEN_FP32_BATCH_DB and every distance within
    GOLDEN_UM of the record or, where neither package reproduces the
    record's per-batch arrays (``fp32_reading``, the port's CPU reading;
    ROADMAP C.10), of that reading, the record's distances printed.
    Returns (readings, launches, seconds by path)."""
    bf16 = torch.bfloat16
    kwargs = {
        "fp32": ("off", {}),
        "int8_stacks_off": ("off", {"quant_scales": scales, "dtype": bf16}),
        "int8_stacks_on": ("on", {"quant_scales": scales, "dtype": bf16}),
        "refined": ("off", {"refine_steps": REFINE_STEPS}),
        "bf16": ("off", {"dtype": bf16}),
    }
    runs, seconds = {}, {}
    asm_cuda.reset_launches()
    conv_stack.reset_launches()
    try:
        for path in paths:
            stacks, kw = kwargs[path]
            quant.set_fused_stacks(stacks)
            t0 = time.monotonic()
            runs[path] = evaluate_golden_suite(net, goldens, cfg, style_override=style, device=device, **kw)
            torch.cuda.synchronize()
            seconds[path] = time.monotonic() - t0
    finally:
        quant.set_fused_stacks("auto")
    launches = {**asm_cuda.LAUNCHES, **conv_stack.LAUNCHES}
    tc = dict(conv_stack.TC_LAUNCHES)

    rec = records["fp32"]
    readings = {}
    if "fp32" in runs:
        fp = runs["fp32"]
        held_to = fp32_reading or rec
        batch_db = _max_diff(fp["psnr_per_batch"], rec["psnr_per_batch"])
        tight_db = _max_diff(fp["psnr_per_batch"], held_to["psnr_per_batch"])
        um = _max_diff(fp["distance_pred_um"], held_to["distance_pred_um"])
        readings["fp32"] = {
            "mean_psnr": fp["mean_psnr"], "record_mean_psnr": rec["mean_psnr"],
            "heldout_mean_psnr": fp["heldout_mean_psnr"], "r2": fp["r2"], "record_r2": rec["r2"],
            "max_batch_psnr_diff_db": batch_db, "max_distance_diff_um": um,
            "batch_db_limits": [GOLDEN_BATCH_DB, GOLDEN_FP32_BATCH_DB],
            "tight_batch_psnr_diff_db": tight_db,
            "tight_against": fp32_reading["command"] if fp32_reading else "the record",
            "max_distance_diff_vs_record_um": _max_diff(fp["distance_pred_um"], rec["distance_pred_um"]),
            "batch_db_margin": GOLDEN_FP32_BATCH_DB - tight_db,
            "held": batch_db < GOLDEN_BATCH_DB and tight_db < GOLDEN_FP32_BATCH_DB and um < GOLDEN_UM}
    if "int8_stacks_off" in runs:
        readings["int8_stacks_off"] = suite_rule(runs["int8_stacks_off"], records["int8"])
    if "int8_stacks_on" in runs:
        on = runs["int8_stacks_on"]
        readings["int8_stacks_on"] = {
            "mean_psnr": on["mean_psnr"], "heldout_mean_psnr": on["heldout_mean_psnr"], "r2": on["r2"],
            "tensor_core_launches": tc,
            **({"minus_stacks_off_db": on["mean_psnr"] - runs["int8_stacks_off"]["mean_psnr"]}
               if "int8_stacks_off" in runs else {})}
    if "refined" in runs:
        ref = runs["refined"]
        d_ref = ref["mean_psnr"] - rec["refined_mean_psnr"]
        d_held = ref["heldout_mean_psnr"] - rec["refined_heldout_mean_psnr"]
        readings["refined"] = {
            "mean_psnr": ref["mean_psnr"], "record_mean_psnr": rec["refined_mean_psnr"],
            "heldout_mean_psnr": ref["heldout_mean_psnr"],
            "record_heldout_mean_psnr": rec["refined_heldout_mean_psnr"],
            "mean_psnr_diff_db": d_ref, "heldout_diff_db": d_held,
            "held": abs(d_ref) < REFINE_DB_TOL and abs(d_held) < REFINE_DB_TOL}
    if "bf16" in runs:
        # a release without a bf16 record (the flagship): printed, not held
        readings["bf16"] = (suite_rule(runs["bf16"], records["bf16"]) if "bf16" in records
                            else {"mean_psnr": runs["bf16"]["mean_psnr"], "r2": runs["bf16"]["r2"],
                                  "heldout_mean_psnr": runs["bf16"]["heldout_mean_psnr"],
                                  "minus_fp32_db": runs["bf16"]["mean_psnr"] - runs["fp32"]["mean_psnr"],
                                  "gated": False})
    n = goldens.n_batches
    stacks_on = n if "int8_stacks_on" in runs else 0
    want = {"asm_const": len(runs) * n, "asm_dynamic": n * (REFINE_STEPS + 1) if "refined" in runs else 0,
            "fused_encoder_head": stacks_on, "fused_conv_tail": stacks_on}
    misses = [p for p, r in readings.items() if not r.get("held", True)]
    if launches != want or tc != conv_stack.LAUNCHES or misses:
        emit({"golden_readings": readings, "launches": launches, "want_launches": want})
        _die(f"the release on the card missed {misses or 'its launch counts'}", 1)
    return readings, launches, seconds


def read_release(path: str):
    """An orbax release read by the port's own reader (``bead``'s, saved on
    a TPU, with no target): (its state dict, the read's seconds and
    bytes)."""
    t0 = time.monotonic()
    store = ocdbt.Store(path)
    tree = orbax_read.restore(path, store=store)
    read = {"seconds": time.monotonic() - t0,
            "bytes": store.bytes_read + os.path.getsize(os.path.join(path, "_METADATA"))}
    return convert_params(tree["params"]), read


def drive_release(goldens, device, smi) -> dict:
    """The flagship release (``checkpoints/release``, width 1.0) read by
    the port's own orbax reader and held to its records on the card: fp32,
    int8 with the stacks off and on, refined (``run_golden``; the flagship
    has no bf16 record: its bf16 mean is printed). The CLI's loader with no
    ``--checkpoint`` must give the same state dict."""
    state, read = read_release(os.path.join(FLAGSHIP, "release"))
    with open(os.path.join(FLAGSHIP, "config.json")) as f:
        cfg = ExperimentConfig.from_json(f.read())
    net = StyleTransferNet.from_state_dict(state, cfg.model.width).to(device)
    style = load_style_vector(os.path.join(FLAGSHIP, "style_vector.npz"))
    scales = quant.load_scales(os.path.join(FLAGSHIP, "quant_scales.json"))
    records = {}
    for kind, name in (("fp32", "golden_metrics.json"), ("int8", "quant_golden_metrics.json")):
        with open(os.path.join(FLAGSHIP, name)) as f:
            records[kind] = json.load(f)
    with contextlib.chdir(REPO):
        default = port_cli._load_params(argparse.Namespace(checkpoint=None))
    if default.keys() != state.keys() or not all(torch.equal(default[k], state[k]) for k in state):
        _die("cli._load_params with no --checkpoint differs from the flagship release", 1)
    readings, launches, seconds = run_golden(net, goldens, cfg, style, scales, records, device)
    return {"release": "checkpoints/release", "width": cfg.model.width, "read": read,
            "leaves": len(state), "default_load_params_equal": True, "readings": readings,
            "launches": launches, "seconds_by_path": seconds, "nvidia_smi": smi}


def narrow_release(name: str, device):
    """``checkpoints/<name>`` on the card: (net, config, style vector, int8
    scales, records: fp32 and int8, the read's seconds and bytes)."""
    root = os.path.join(REPO, "checkpoints", name)
    state, read = read_release(os.path.join(root, "release"))
    with open(os.path.join(root, "config.json")) as f:
        cfg = ExperimentConfig.from_json(f.read())
    net = StyleTransferNet.from_state_dict(state, cfg.model.width).to(device)
    records = {}
    for kind, fname in (("fp32", "golden_metrics.json"), ("int8", "quant_golden_metrics.json")):
        with open(os.path.join(root, fname)) as f:
            records[kind] = json.load(f)
    return (net, cfg, load_style_vector(os.path.join(root, "style_vector.npz")),
            quant.load_scales(os.path.join(root, "quant_scales.json")), records, read)


@contextlib.contextmanager
def propagate_never_through_torch_fft():
    """``ops.asm.propagate_torch`` dies while the block runs: a propagation
    that fell back to the ``torch.fft`` composition instead of a kernel
    fails the phase."""
    real = asm_ops.propagate_torch

    def refused(*args, **kwargs):
        _die("a propagation fell back to torch.fft on the card", 1)

    asm_ops.propagate_torch = refused
    try:
        yield
    finally:
        asm_ops.propagate_torch = real


def refine_distance_launches(batches: int, steps: int) -> dict:
    """A refine with the distance over ``batches`` golden batches: a batch's
    refocus (one ``asm_const``), max(steps // 2, 10) distance steps, ``steps``
    joint steps and the residual (one ``asm_dynamic`` each)."""
    return {"asm_const": batches, "asm_dynamic": batches * (max(steps // 2, 10) + steps + 1),
            "fused_encoder_head": 0, "fused_conv_tail": 0}


def narrow_refine_distance(net, goldens, cfg, style, record, reading, device) -> dict:
    """The refine with the distance at NARROW_REFINE_DISTANCE_STEPS on the
    first NARROW_REFINE_DISTANCE_BATCHES golden batches on the card, batch by
    batch as the JAX package refines, held to the port's CPU reading of the
    same batches; the launches counted from 0 around it."""
    n, steps = NARROW_REFINE_DISTANCE_BATCHES, NARROW_REFINE_DISTANCE_STEPS
    if (reading["batches"], reading["refine_steps"], reading["threads"]) != (n, steps, FEW_THREADS):
        _die(f"{GOLDEN_CPU_READINGS} holds another reading: {reading['command']}", 1)
    asm_cuda.reset_launches()
    conv_stack.reset_launches()
    t0 = time.monotonic()
    with propagate_never_through_torch_fft():
        got = evaluate_golden_suite(net, goldens.subset(n), cfg, style_override=style, refine_steps=steps,
                                    refine_distance=True, device=device)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    launches = {**asm_cuda.LAUNCHES, **conv_stack.LAUNCHES}
    want = refine_distance_launches(n, steps)
    d_db, d_r2 = got["mean_psnr"] - reading["mean_psnr"], got["r2"] - reading["r2"]
    out = {"batches": n, "steps": steps, "mean_psnr": got["mean_psnr"], "r2": got["r2"],
           "cpu_mean_psnr": reading["mean_psnr"], "cpu_r2": reading["r2"], "cpu_threads": reading["threads"],
           "mean_psnr_diff_db": d_db, "r2_diff": d_r2,
           "batch_psnr_diff_db": [a - b for a, b in zip(got["psnr_per_batch"], reading["psnr_per_batch"])],
           "max_distance_diff_um": _max_diff(got["distance_pred_um"], reading["distance_pred_um"]),
           "limits": [REFINE_DB_TOL, SUITE_R2],
           "record_20_batches": {"mean_psnr": record["refine_distance_mean_psnr"], "r2": record["refine_distance_r2"],
                                 "steps": record["refine_distance_steps"]},
           "launches": launches, "want_launches": want, "seconds": seconds}
    if abs(d_db) >= REFINE_DB_TOL or abs(d_r2) >= SUITE_R2 or launches != want:
        emit({"narrow_refine_distance": out})
        _die("the refine with the distance on the card missed the port's CPU reading or its launches", 1)
    return out


@contextlib.contextmanager
def recording_golden_suites():
    """``pipelines.evaluate_golden_suite``, which ``cli eval`` imports at its
    call, with each call's metrics recorded: yields the list."""
    seen, real = [], port_pipelines.evaluate_golden_suite

    def recording(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]

    port_pipelines.evaluate_golden_suite = recording
    try:
        yield seen
    finally:
        port_pipelines.evaluate_golden_suite = real


def cli_refine_distance(net, goldens, cfg, style, device) -> dict:
    """``cli eval --checkpoint checkpoints/<NARROW_CLI_RELEASE>/release
    --refine N --refine-distance`` in process on the card (the CLI scores the
    whole suite) against the direct ``evaluate_golden_suite`` call with the
    same arguments: the flag must reach the path."""
    steps = NARROW_CLI_REFINE_STEPS
    argv = ["eval", "--checkpoint", os.path.join(REPO, "checkpoints", NARROW_CLI_RELEASE, "release"),
            "--save-dir", "", "--refine", str(steps), "--refine-distance", "--json"]
    asm_cuda.reset_launches()
    conv_stack.reset_launches()
    t0 = time.monotonic()
    with recording_golden_suites() as seen, propagate_never_through_torch_fft():
        lines, _ = run_cli(argv)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    launches = {**asm_cuda.LAUNCHES, **conv_stack.LAUNCHES}
    want = refine_distance_launches(goldens.n_batches, steps)
    direct = evaluate_golden_suite(net, goldens, cfg, style_override=style, refine_steps=steps,
                                   refine_distance=True, device=device)
    got = seen[0]
    batch_db = _max_diff(got["psnr_per_batch"], direct["psnr_per_batch"])
    um = _max_diff(got["distance_pred_um"], direct["distance_pred_um"])
    out = {"argv": argv, "printed": lines, "mean_psnr": got["mean_psnr"], "r2": got["r2"],
           "direct_mean_psnr": direct["mean_psnr"], "direct_r2": direct["r2"],
           "max_batch_psnr_diff_db": batch_db, "max_distance_diff_um": um,
           "limits": [CLI_REPEAT_DB, CARD_CPU_UM], "launches": launches, "want_launches": want,
           "seconds": seconds}
    if len(seen) != 1 or batch_db > CLI_REPEAT_DB or um > CARD_CPU_UM or launches != want:
        emit({"cli_refine_distance": out})
        _die("cli eval --refine-distance on the card differs from the direct call or its launches", 1)
    return out


def drive_narrow_releases(goldens, device, smi) -> dict:
    """The narrow_releases phase (see the module docstring); returns its
    readings and the launches of every path it counted, summed."""
    with open(GOLDEN_CPU_READINGS) as f:
        cpu = json.load(f)
    releases, total = {}, collections.Counter()
    for name in NARROW_RELEASES:
        net, cfg, style, scales, records, read = narrow_release(name, device)
        if name in NARROW_INT8_R2_FROM_CPU:
            reading = cpu[name]["int8"]
            if reading["batches"] != goldens.n_batches or reading["fused_stacks"] != "off":
                _die(f"{GOLDEN_CPU_READINGS} holds another int8 reading of {name}: {reading['command']}", 1)
            int8_r2 = {"record_r2": records["int8"]["r2"], "cpu_r2": reading["r2"], "command": reading["command"]}
            records["int8"] = {**records["int8"], "r2": reading["r2"]}
        readings, launches, seconds = run_golden(net, goldens, cfg, style, scales, records, device,
                                                 paths=NARROW_PATHS, fp32_reading=cpu[name]["fp32"])
        total.update(launches)
        entry = {"width": cfg.model.width, "read": read, "readings": readings, "launches": launches,
                 "seconds_by_path": seconds}
        if name in NARROW_INT8_R2_FROM_CPU:
            entry["int8_r2_held_to_the_cpu_reading"] = int8_r2
        if name in NARROW_REFINE_DISTANCE:
            entry["refine_distance"] = narrow_refine_distance(
                net, goldens, cfg, style, records["fp32"], cpu[name]["refine_distance"], device)
            total.update(entry["refine_distance"]["launches"])
        if name == NARROW_CLI_RELEASE:
            entry["cli_refine_distance"] = cli_refine_distance(net, goldens, cfg, style, device)
            total.update(entry["cli_refine_distance"]["launches"])
        releases[name] = entry
        del net
    return {"nvidia_smi": smi, "releases": releases, "launches": dict(total)}


@contextlib.contextmanager
def serving(service):
    """``service`` behind ``serve_forever`` on 127.0.0.1, port 0, in a daemon
    thread; yields its URL and shuts the server down on the way out."""
    box, bound = {}, threading.Event()

    def ready(httpd):
        box["httpd"] = httpd
        bound.set()

    t = threading.Thread(target=serve_forever, args=(service, "127.0.0.1", 0),
                         kwargs={"ready": ready}, daemon=True)
    t.start()
    if not bound.wait(30):
        _die("the server did not bind its socket", 1)
    try:
        yield f"http://127.0.0.1:{box['httpd'].server_address[1]}"
    finally:
        box["httpd"].shutdown()
        t.join(30)


def direct_answer(fn, net, holo, style, d_style, batch, device, refine=None):
    """What a service must answer: the direct retrieval call on each chunk
    of ``batch``, the last padded with its last frame, trimmed; with
    ``refine`` (physics, steps) refined as the service refines."""
    outs = []
    for lo in range(0, len(holo), batch):
        chunk = holo[lo : lo + batch]
        n = len(chunk)
        x = torch.from_numpy(np.concatenate([chunk, np.repeat(chunk[-1:], batch - n, axis=0)])).to(device)
        out = fn(net, x, *style, d_style)
        if refine is not None:
            out = refine_retrieval(out, x, refine[0], steps=refine[1], device=device)
        outs.append({k: v[:n].float().cpu().numpy() for k, v in out.items()})
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


def check_equal(got, want, label):
    diff = {k: float(np.abs(got[k] - want[k]).max()) for k in want if got[k].shape == want[k].shape}
    if set(got) != set(want) or len(diff) != len(want) or any(diff.values()):
        _die(f"{label}: the answer is not the direct call's: {diff}", 1)


def _npz(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def _unnpz(blob: bytes):
    with np.load(io.BytesIO(blob)) as z:
        return {k: z[k] for k in z.files}


def served_rates(service, url, fn, net, style_dev, d_style, holo):
    """Holograms/s at the service's batch: over HTTP, through
    ``retrieve`` in process (host arrays in and out), and by the direct call
    on a batch already on the card (CUDA events); and the host's share of a
    request spent on its wire format, the compressed npz of the request and
    of the answer, each encoded and decoded once."""
    b = len(holo)
    x = torch.from_numpy(holo).to(service.device)
    host = dict(reps=SERVE_TIMED, warmup=1, cuda=False)
    ms = {
        "direct_on_card": median_ms(lambda: fn(net, x, *style_dev, d_style), reps=SERVE_TIMED, warmup=2),
        "retrieve_in_process": median_ms(lambda: service.retrieve(holo), **host),
        "http": median_ms(lambda: retrieve_remote(url, holo), **host),
    }
    answer = service.retrieve(holo)
    request_blob, answer_blob = _npz(holo=holo), _npz(**answer)
    host = dict(reps=WIRE_TIMED, warmup=0, cuda=False)
    wire = {
        "request_encode": median_ms(lambda: _npz(holo=holo), **host),
        "request_decode": median_ms(lambda: _unnpz(request_blob), **host),
        "answer_encode": median_ms(lambda: _npz(**answer), **host),
        "answer_decode": median_ms(lambda: _unnpz(answer_blob), **host),
    }
    return {"ms": ms, "holograms_per_s": {k: b / v * 1e3 for k, v in ms.items()},
            "wire_ms": wire, "wire_bytes": {"request": len(request_blob), "answer": len(answer_blob)}}


def served(url, holo, want):
    """One request over HTTP, with the ASM kernels' counts set to 0 just
    before it and read just after; fails unless they are ``want``, the
    launches the request implies. Returns (answer, launches)."""
    torch.cuda.synchronize()
    asm_cuda.reset_launches()
    got = retrieve_remote(url, holo)
    torch.cuda.synchronize()
    launches = dict(asm_cuda.LAUNCHES)
    if launches != want:
        _die(f"a request of {len(holo)} launched {launches}, want {want}", 1)
    return got, launches


def drive_serve(fast_net, fast_cfg, fast_style, fast_scales, goldens, dev, card_name, smi):
    """The serve phase (see the module docstring); returns its readings.
    Its launches are those of the served requests alone: every direct call
    they are compared with, and every timing, runs outside the counts."""
    bf16 = torch.bfloat16
    d_style = float(fast_cfg.physics.to_network_units(fast_cfg.data.style_distances[0]))
    style_dev = tuple(torch.as_tensor(v, device=dev) for v in fast_style)
    kw = dict(batch_size=SERVE_BATCH, device=dev)
    services = {
        "bf16": RetrievalService(fast_net, fast_style, fast_cfg, dtype=bf16, **kw),
        "int8": RetrievalService(fast_net, fast_style, fast_cfg, quant_scales=fast_scales, **kw),
        "refine": RetrievalService(fast_net, fast_style, fast_cfg, dtype=bf16,
                                   refine_steps=SERVE_REFINE_STEPS, **kw),
    }
    fns = {
        "bf16": make_retrieval_fn(fast_cfg.physics, dtype=bf16, device=dev),
        "int8": make_retrieval_fn(fast_cfg.physics, quant_scales=fast_scales, device=dev),
    }
    fns["refine"] = fns["bf16"]
    all_holo = goldens.content_holo.reshape(-1, 1, IMAGE, IMAGE)
    for service in services.values():
        service.warmup()
    requests, launches = {}, collections.Counter()
    with serving(services["bf16"]) as url:
        for b in SERVE_REQUESTS:
            holo = all_holo[:b] if b != 5 else goldens.content_holo[10]
            chunks = -(-b // SERVE_BATCH)
            got, n = served(url, holo, {"asm_const": chunks, "asm_dynamic": 0})
            launches.update(n)
            check_equal(got, direct_answer(fns["bf16"], fast_net, holo, fast_style, d_style,
                                           SERVE_BATCH, dev), f"bf16 request of {b}")
            requests[f"bf16_B{b}"] = {"equal": True, "chunks": chunks, "launches": n}
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
        if health["device"] != card_name or health["batch_size"] != SERVE_BATCH:
            _die(f"/healthz: {health}", 1)
        buf = io.BytesIO()
        np.savez(buf, nope=np.zeros(2, np.float32))
        try:
            urllib.request.urlopen(urllib.request.Request(
                url + "/retrieve", data=buf.getvalue(), method="POST"), timeout=30)
            _die("a request without holo was answered", 1)
        except urllib.error.HTTPError as e:
            if e.code != 400:
                _die(f"a request without holo got {e.code}, want 400", 1)
        rates = {"bf16": served_rates(services["bf16"], url, fns["bf16"], fast_net, style_dev,
                                      d_style, all_holo[:SERVE_BATCH])}
    x = torch.from_numpy(all_holo[:SERVE_BATCH]).to(dev)
    fp32_fn = make_retrieval_fn(fast_cfg.physics, dtype=torch.float32, device=dev)
    fp32_ms = median_ms(lambda: fp32_fn(fast_net, x, *style_dev, d_style), reps=SERVE_TIMED, warmup=2)
    rates["fp32"] = {"ms": {"direct_on_card": fp32_ms},
                     "holograms_per_s": {"direct_on_card": SERVE_BATCH / fp32_ms * 1e3}}
    for path, want in (("int8", {"asm_const": 1, "asm_dynamic": 0}),
                       ("refine", {"asm_const": 1, "asm_dynamic": SERVE_REFINE_STEPS + 1})):
        with serving(services[path]) as url:
            holo = goldens.content_holo[10]
            got, n = served(url, holo, want)
            launches.update(n)
            refine = (fast_cfg.physics, SERVE_REFINE_STEPS) if path == "refine" else None
            check_equal(got, direct_answer(fns[path], fast_net, holo, fast_style, d_style,
                                           SERVE_BATCH, dev, refine), f"{path} request")
            requests[f"{path}_B5"] = {"equal": True, "launches": n}
            if path == "int8":
                rates["int8"] = served_rates(services["int8"], url, fns["int8"], fast_net,
                                             style_dev, d_style, all_holo[:SERVE_BATCH])
    torch.cuda.synchronize()
    return {"nvidia_smi": smi, "batch": SERVE_BATCH, "requests": requests,
            "health": health, "rates": rates, "launches": dict(launches),
            "tolerance": "bit-equal (same batch shapes on the card)"}


def drive_serve_domain(dev, smi) -> dict:
    """The service that ``serve --checkpoint checkpoints/rbc_release --quant
    auto`` runs (``cli.build_service``): its ``loaded`` lines must name rbc's
    release, sibling style vector and band-limited config, and its answers
    must be those of rbc's int8 scales and style vector, which the
    flagship's would change. Two requests over HTTP (5 and 37 holograms of
    the rbc stream: one chunk, and two with the last padded), each launching
    no kernel and equal bit for bit to the direct int8 call on the service's
    net with rbc's files."""
    ckpt = os.path.join(REPO, "checkpoints")
    argv = ["serve", "--checkpoint", RBC_RELEASE, "--quant", "auto"]
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        service = port_cli.build_service(port_cli.build_parser().parse_args(argv))
    if service is None:
        _die(f"cli.build_service({argv}) found no style vector: {err.getvalue()}", 1)
    with open(os.path.join(ckpt, "rbc_config.json")) as f:
        cfg = ExperimentConfig.from_json(f.read())
    scales = quant.load_scales(os.path.join(ckpt, "rbc_quant_scales.json"))
    style = load_style_vector(os.path.join(ckpt, "rbc_style_vector.npz"))
    loaded = {
        line: line in err.getvalue()
        for line in (f"loaded checkpoint {RBC_RELEASE}",
                     f"loaded style vector {os.path.join(ckpt, 'rbc_style_vector.npz')}",
                     f"loaded run config {os.path.join(ckpt, 'rbc_config.json')}")
    }
    loaded["rbc_config_physics"] = service.config.physics == cfg.physics and cfg.physics.band_limit
    loaded["quantized"] = service.health()["quantized"]
    if not all(loaded.values()):
        _die(f"the rbc service loaded other files than rbc's: {loaded}; stderr: {err.getvalue()}", 1)
    proto, _, bank, _ = domain_protocol("rbc")
    holo = np.concatenate([domain_stream_batch(proto, bank, dev, i)[0].cpu().numpy() for i in (0, 1)])
    d_style = float(cfg.physics.to_network_units(cfg.data.style_distances[0]))
    fn = make_retrieval_fn(cfg.physics, alpha=cfg.eval.alpha, dtype=torch.bfloat16, quant_scales=scales,
                           device=dev)
    service.warmup()
    requests, answers = {}, {}
    with serving(service) as url:
        for b in (5, 37):
            torch.cuda.synchronize()
            _reset_launch_counts()
            t0 = time.monotonic()
            got = retrieve_remote(url, holo[:b])
            torch.cuda.synchronize()
            seconds = time.monotonic() - t0
            launches = _launch_counts()
            if any(launches.values()):
                _die(f"a band-limited rbc request of {b} launched {launches}", 1)
            check_equal(got, direct_answer(fn, service.net, holo[:b], style, d_style, service.batch_size, dev),
                        f"rbc int8 request of {b}")
            requests[f"B{b}"] = {"equal": True, "launches": launches, "seconds": seconds}
            answers[b] = got
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
    if not health["quantized"] or health["batch_size"] != SERVE_BATCH:
        _die(f"the rbc service's /healthz: {health}", 1)
    # The flagship's int8 scales, or its style vector, answer otherwise.
    flagship_fn = make_retrieval_fn(cfg.physics, alpha=cfg.eval.alpha, dtype=torch.bfloat16, device=dev,
                                    quant_scales=quant.load_scales(os.path.join(ckpt, "quant_scales.json")))
    flagship_style = load_style_vector(os.path.join(ckpt, "style_vector.npz"))
    for name, (other_fn, other_style) in {"flagship_scales": (flagship_fn, style),
                                          "flagship_style": (fn, flagship_style)}.items():
        other = direct_answer(other_fn, service.net, holo[:5], other_style, d_style, service.batch_size, dev)
        loaded[f"{name}_answer_otherwise"] = any(not np.array_equal(other[k], answers[5][k]) for k in other)
    if not all(loaded.values()):
        _die(f"the rbc service's answers do not tell rbc's files from the flagship's: {loaded}", 1)
    x = torch.from_numpy(holo[:SERVE_BATCH]).to(dev)
    direct_ms = median_ms(lambda: fn(service.net, x, *style, d_style), reps=SERVE_TIMED, warmup=2)
    return {"nvidia_smi": smi, "argv": argv, "loaded": loaded, "health": health, "requests": requests,
            "direct_int8_ms_B32": direct_ms, "tolerance": "bit-equal (same batch shapes on the card)"}


def drive_stream(fast_net, fast_cfg, fast_style, goldens, dev, smi):
    """The stream phase (see the module docstring); returns its readings."""
    d_style = float(fast_cfg.physics.to_network_units(fast_cfg.data.style_distances[0]))
    all_holo = goldens.content_holo.reshape(-1, 1, IMAGE, IMAGE)
    batches = [{"holo": all_holo[lo : lo + STREAM_BATCH]} for lo in range(0, len(all_holo), STREAM_BATCH)]
    asm_cuda.reset_launches()
    stats = StreamStats()
    outs = list(stream_retrieval(fast_net, batches, fast_style, fast_cfg, stats=stats, device=dev))
    torch.cuda.synchronize()
    stream_launches = dict(asm_cuda.LAUNCHES)
    if stream_launches != {"asm_const": len(batches), "asm_dynamic": 0}:
        _die(f"the stream of {len(batches)} batches launched {stream_launches}", 1)
    fn = make_retrieval_fn(fast_cfg.physics, device=dev)
    for i, (batch, out) in enumerate(zip(batches, outs)):
        want = direct_answer(fn, fast_net, batch["holo"], fast_style, d_style, STREAM_BATCH, dev)
        check_equal({k: v.cpu().numpy() for k, v in out.items()}, want, f"stream batch {i}")
    if len(outs) != len(batches) or stats.n_frames != len(all_holo):
        _die(f"the stream yielded {len(outs)} batches, {stats.n_frames} frames", 1)
    timed = StreamStats()
    for _ in stream_retrieval(fast_net, batches, fast_style, fast_cfg, stats=timed, device=dev):
        pass
    torch.cuda.synchronize()
    return {"nvidia_smi": smi, "batch": STREAM_BATCH, "batches": len(batches),
            "last_batch": len(batches[-1]["holo"]), "equal": True,
            "launches": stream_launches,
            "frames_per_s": timed.n_frames / timed.elapsed,
            "first_run_frames_per_s": stats.n_frames / stats.elapsed}


def golden_contents(goldens):
    """The golden suite's sqrt-intensity batches, (B, 1, H, W) each."""
    return [np.sqrt(goldens.content_holo[i]) for i in range(goldens.n_batches)]


def suite_summary(metrics):
    for key in ("mean_psnr", "mean_mae", "r2"):
        if not math.isfinite(metrics[key]):
            _die(f"int8 suite metric {key} is not finite: {metrics[key]}", 1)
    return {k: metrics[k] for k in ("mean_psnr", "heldout_mean_psnr", "mean_mae", "r2")}


def ring_bound(peak_flops, peak_bytes, b: int, layer, dtype):
    """Least time (ms) of the ring at one layer (C, H, W, O) and what bounds
    it: 24 C O (H + W) fp32 FLOP an image (its taps are folded in fp32, so
    its products are fp32 in either type) against the eight edge lines it
    reads, its outputs and the kernel, each once."""
    c, h, w, o = layer
    size = 2 if dtype == torch.bfloat16 else 4
    t_ops = 24 * c * o * (h + w) * b / peak_flops["fp32"] * 1e3
    t_bytes = ((4 * (h + w) * c + 2 * o * (h + w)) * size * b + o * c * 9 * size) / peak_bytes * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def time_ring_step(step_layers, peak_flops, peak_bytes, b: int, device, dtype=torch.float32,
                   plain: bool = False):
    """The ring at each reflect conv of one step in ``dtype``, at batch b:
    by layer (C, H, W, O) its CUDA-event median (with ``plain`` also the
    plain version's), its bound and how many of the step's convs have that
    shape; and the step's sums."""
    by_layer = time_ring_layers(step_layers, b, device, dtype=dtype, plain=plain)
    for v in by_layer.values():
        v["bound_ms"], v["bound_by"] = ring_bound(peak_flops, peak_bytes, b, v.pop("layer"), dtype)
    out = {
        "by_layer": by_layer,
        "step_ms": sum(v["ms"] * v["convs"] for v in by_layer.values()),
        "step_bound_ms": sum(v["bound_ms"] * v["convs"] for v in by_layer.values()),
        "convs": sum(v["convs"] for v in by_layer.values()),
    }
    if plain:
        out["step_plain_ms"] = sum(v["plain_ms"] * v["convs"] for v in by_layer.values())
    return out


def conv_bounds(peak_flops, peak_bytes, b: int):
    """Least time (ms) and what bounds it, for each conv kernel at batch b
    and dtype: the larger of its operations over the card's peak rate for
    their type (bf16 products with fp32 sums at the tensor cores' bf16 rate,
    fp32 at the fp32 rate) and its bytes (each input once, each output
    once) over the memory rate. The ring at the timed layer."""
    hw = IMAGE * IMAGE
    out = {}
    for dtype, kind in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        size = 2 if dtype == torch.bfloat16 else 4
        head_flops = 2 * hw * 9 * (1 * 64 + 64 * 64) * b
        head_bytes = (hw * 1 + 64 * hw // 4) * size * b + (64 * 9 + 64 * 64 * 9) * size + 128 * 4
        tail_flops = 2 * hw * 9 * (64 * 64 + 64 * 64 + 64 * 2) * b
        tail_bytes = (64 * hw + 2 * hw) * size * b + (2 * 64 * 64 * 9 + 2 * 64 * 9) * size + 130 * 4
        for name, flops, nbytes in (("fused_encoder_head", head_flops, head_bytes),
                                    ("fused_conv_tail", tail_flops, tail_bytes)):
            t_ops = flops / peak_flops[kind] * 1e3
            t_bytes = nbytes / peak_bytes * 1e3
            out[name, dtype] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
        out["border_lines", dtype] = ring_bound(peak_flops, peak_bytes, b, RING_LAYERS[0], dtype)
    return out


def _train_cfg(cfg, **data_kw):
    return dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, **data_kw))


def drive_train(cfg, bank, device):
    """(a) ``train()`` from ``init_net_params`` seed 0 for TRAIN_STEPS steps
    at the flagship's configuration, its metrics read back from
    ``train_metrics.jsonl``: every loss term finite, ``asm_dynamic``
    launched twice a step (the synthesis) and nothing else."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        run = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, log_every=1, checkpoint_every=0, checkpoint_dir=tmp))
        asm_cuda.reset_launches()
        reflect_border.reset_launches()
        t0 = time.monotonic()
        train(run, bank=bank, iterations=TRAIN_STEPS, device=device, log_fn=lambda line: None)
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        launches = {**asm_cuda.LAUNCHES, **reflect_border.LAUNCHES}
        with open(os.path.join(tmp, "train_metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
    if len(rows) != TRAIN_STEPS or not all(math.isfinite(v) for r in rows for v in r.values()):
        _die(f"train(): {len(rows)} metric rows, want {TRAIN_STEPS}, all finite: {rows[-1:]}", 1)
    want = {"asm_dynamic": 2 * TRAIN_STEPS, "asm_const": 0, "border_lines": 0}
    if launches != want:
        _die(f"train() launched {launches}, want {want}", 1)
    return {"steps": TRAIN_STEPS, "batch": cfg.data.batch_size, "seconds": seconds,
            "launches": launches, "first": rows[0], "last": rows[-1]}


def adam_first_step_spread(g: torch.Tensor, noise: float, lr: float) -> torch.Tensor:
    """The widest gap between Adam's first steps, lr g'/(|g'| + eps), of two
    gradients g' within ``noise`` of ``g``: 2 lr where that interval holds
    zero (the sign is free), 0 where ``g`` is exactly zero (no product
    reaches the element on either device)."""
    hi, lo = g.abs() + noise, g.abs() - noise
    spread = lr * ADAM_EPS * (hi - lo) / ((hi + ADAM_EPS) * (lo + ADAM_EPS))
    return torch.where(g == 0, torch.zeros_like(g), torch.where(lo > 0, spread, torch.full_like(g, 2 * lr)))


def compare_states(got, want, anchor: dict, paths: tuple, train_cfg, label: str) -> dict:
    """After one step: every element of params, EMA and discriminator within
    TRAIN_LEAF_TOL of its leaf's max plus the spread of Adam's first step
    (``adam_first_step_spread``) over the gradients that the leaf's fp32
    noise allows around the float64 one in ``anchor``: the noise is the two
    compared runs' largest distance from it (``paths``, from
    ``step_gradients``), both scaled by the clip of the anchor's global
    norm; the EMA moves by (1 - decay) of the params. The worst element's
    share of its bound in each group, and the count of elements whose
    spread exceeds TRAIN_LEAF_TOL of their leaf's max."""
    out = {}
    for group in ("params", "ema_params", "disc_params"):
        a, b = getattr(got, group), getattr(want, group)
        if b is None:
            continue
        grad_group = "disc_params" if group == "disc_params" else "params"
        clip = 1.0
        if grad_group == "params" and train_cfg.grad_clip_norm:
            norm = math.sqrt(sum(float((g * g).sum()) for g in anchor["params"].values()))
            clip = min(1.0, train_cfg.grad_clip_norm / norm)
        scale = 1.0 - train_cfg.ema_decay if group == "ema_params" else 1.0
        shares, loose, total = {}, 0, 0
        for k in b:
            g = anchor[grad_group][k]
            noise = max(float((path[grad_group][k] - g).abs().max()) for path in paths)
            spread = scale * adam_first_step_spread(clip * g, clip * noise, train_cfg.lr)
            floor = TRAIN_LEAF_TOL * float(b[k].abs().max())
            d = (a[k].cpu().double() - b[k].cpu().double()).abs()
            shares[k] = float((d / (floor + spread).clamp_min(1e-30)).max())
            loose += int((spread > floor).sum())
            total += g.numel()
        worst = max(shares, key=shares.get)
        out[group] = {"worst_share_of_bound": shares[worst], "leaf": worst, "elements": total,
                      "elements_beyond_leaf_tol": loose}
        if not shares[worst] < 1.0:
            _die(f"{label}: {group} off: {json.dumps(out[group])}", 1)
    return out


def compare_aux(got, want, label: str, tol: float = TRAIN_AUX_RTOL) -> float:
    worst = max(abs(float(got[k]) - float(want[k])) / max(abs(float(want[k])), 1e-30) for k in want)
    if set(got) != set(want) or not worst < tol:
        _die(f"{label}: aux off by {worst:.3e} relative: {got} vs {want}", 1)
    return worst


@functools.lru_cache(maxsize=None)
def step_modules(width: float, image_size: int, device, dtype):
    """The net (its distance head fp32) and the discriminator that
    ``step_gradients`` runs params through, built once for each
    configuration: ``functional_call`` takes every weight from the params it
    is given."""
    net = StyleTransferNet(width=width).to(device, dtype)
    net.distance_g.float()
    return net, PatchDiscriminator(image_size=image_size).to(device, dtype)


def step_gradients(cfg, params, disc_params, batch, device, dtype=torch.float32, backend="auto",
                   compute=torch.float32, host=True, aux_out=None):
    """The gradients of one step (every leaf, float64 on the CPU) at
    ``params`` on ``batch``: ``generator_loss_fn``'s under "params", and
    under "disc_params" the discriminator's LSGAN loss at ``disc_params`` on
    the style holograms and the forward's detached ``g_t``, as
    ``TrainStep.disc_step`` takes it. The net and discriminator in
    ``dtype``, the distance head in fp32, the reflect ``backend``; the net
    computes in ``compute`` (bf16: mixed precision, the params fp32). With
    ``use_dropout`` the masks come from the stream's generator of step 0,
    the same for every call. With ``host`` off the gradients stay where
    they were computed, in their dtype. ``aux_out`` (a dict) gets the
    loss and its terms."""
    set_reflect_backend(backend)
    net, disc = step_modules(cfg.model.width, cfg.data.image_size, device, dtype)
    p = {k: (v.float() if k.startswith("distance_g.") else v.to(dtype)).to(device).requires_grad_()
         for k, v in params.items()}
    b = {k: v.to(device, dtype) for k, v in batch.items()}
    dp = {k: v.to(device, dtype) for k, v in disc_params.items()}
    dropout = synth.stream_generator(cfg.data.seed + 2, 0) if cfg.train.use_dropout else None
    loss, aux = generator_loss_fn(p, b, net=net, physics=cfg.physics, cfg=cfg.train, disc=disc,
                                  disc_params=dp, dropout=dropout, dtype=compute)
    grads = torch.autograd.grad(loss, list(p.values()))
    if aux_out is not None:
        aux_out.update({k: float(v.detach()) for k, v in aux.items() if k != "g_t"},
                       loss=float(loss.detach()))
    dp = {k: v.requires_grad_() for k, v in dp.items()}
    real, _ = functional_call(disc, dp, (b["style_holo"],))
    fake, _ = functional_call(disc, dp, (aux["g_t"].detach().to(dtype),))
    dgrads = torch.autograd.grad(lsgan_d_loss(real, fake), list(dp.values()), allow_unused=True)
    set_reflect_backend("auto")
    to = (lambda g: g.double().cpu()) if host else (lambda g: g)  # noqa: E731
    leaf = lambda g, like: to((torch.zeros_like(like) if g is None else g).detach())  # noqa: E731
    return {"params": {k: leaf(g, p[k]) for k, g in zip(p, grads)},
            "disc_params": {k: leaf(g, dp[k]) for k, g in zip(dp, dgrads)}}


def check_gradients(paths: dict, anchor: dict, label: str) -> dict:
    """Each fp32 path's gradients, the generator's and the discriminator's,
    within TRAIN_GRAD_TOL of each leaf's max of the float64 ``anchor``; the
    worst leaf of each."""
    out = {}
    for name, grads in paths.items():
        errs = {k: float((grads[group][k] - want[k]).abs().max() / want[k].abs().max())
                for group, want in anchor.items() for k in want if float(want[k].abs().max()) > 0}
        worst = max(errs, key=errs.get)
        out[name] = {"worst": errs[worst], "leaf": worst}
        if not errs[worst] < TRAIN_GRAD_TOL:
            _die(f"{label}: {name} gradients off the float64 ones: {json.dumps(out[name])}", 1)
    return out


def optimizer_card_vs_cpu(cfg, params, disc_params, grads, device) -> dict:
    """The optimizer, EMA and the discriminator's Adam on the card and on the
    CPU, given the same gradients (``grads``, and seeded ones for the
    discriminator): every leaf within TRAIN_OPT_TOL of its max."""
    g = torch.Generator().manual_seed(5)
    dgrads = {k: torch.randn(v.shape, generator=g) for k, v in disc_params.items()}
    states = {}
    for dev in ("cpu", device):
        state = create_train_state(params, cfg.train, disc_params=disc_params, device=dev)
        apply_gradients(state, {k: grads[k].float().to(dev) for k in state.opt_state.mu},
                        make_optimizer(cfg.train), cfg.train.ema_decay)
        apply_disc_gradients(state, {k: v.to(dev) for k, v in dgrads.items()}, make_disc_optimizer(cfg.train))
        states[str(dev)] = state
    out = {}
    for group in ("params", "ema_params", "disc_params"):
        a, b = getattr(states[str(device)], group), getattr(states["cpu"], group)
        out[group] = max(float((a[k].cpu() - b[k]).abs().max() / b[k].abs().max()) for k in b)
        if not out[group] < TRAIN_OPT_TOL:
            _die(f"the optimizer on the card and the CPU differ: {out}", 1)
    return out


def one_train_step(cfg, params, disc_params, batch, device, backend="auto"):
    """One TrainStep of the flagship's config from ``params`` on ``batch``
    on ``device`` with the reflect ``backend``: (state, aux)."""
    set_reflect_backend(backend)
    net = StyleTransferNet(width=cfg.model.width).to(device)
    disc = PatchDiscriminator(image_size=cfg.data.image_size).to(device)
    state = create_train_state(params, cfg.train, disc_params=disc_params, device=device)
    state, aux = TrainStep(net, cfg.physics, cfg.train, disc=disc)(
        state, {k: v.to(device) for k, v in batch.items()})
    set_reflect_backend("auto")
    return state, {k: float(v) for k, v in aux.items()}


def train_step_card_vs_cpu(cfg, bank, device):
    """(b) One step at width 1.0, B = TRAIN_CMP_BATCH, on the card and on the
    CPU from the same params and the same CPU-synthesized batch: aux, the
    gradients of both against a float64 evaluation on the card, the
    optimizer given the same gradients, and the updated states."""
    small = _train_cfg(cfg, batch_size=TRAIN_CMP_BATCH)
    params = init_net_params(torch.Generator().manual_seed(0), width=cfg.model.width)
    disc_params = init_params(PatchDiscriminator(image_size=cfg.data.image_size),
                              torch.Generator().manual_seed(1))
    batch = synth.synth_batch(0, torch.as_tensor(bank), small.data, cfg.physics, return_gt=True)
    t0 = time.monotonic()
    cpu_state, cpu_aux = one_train_step(small, params, disc_params, batch, "cpu")
    cpu_seconds = time.monotonic() - t0
    card_state, card_aux = one_train_step(small, params, disc_params, batch, device)
    grads = {"card": step_gradients(small, params, disc_params, batch, device),
             "cpu": step_gradients(small, params, disc_params, batch, "cpu")}
    anchor = step_gradients(small, params, disc_params, batch, device, torch.float64)
    return {"B": TRAIN_CMP_BATCH, "cpu_step_seconds": cpu_seconds,
            "aux_rel_err": compare_aux(card_aux, cpu_aux, "one train step, card against CPU"),
            "gradients_vs_float64": check_gradients(grads, anchor, "one train step"),
            "optimizer_rel_err": optimizer_card_vs_cpu(small, params, disc_params, grads["cpu"]["params"],
                                                       device),
            "states": compare_states(card_state, cpu_state, anchor, (grads["card"], grads["cpu"]),
                                     cfg.train, "one train step, card against CPU"),
            "params": params, "disc_params": disc_params, "batch": batch, "anchor": anchor,
            "card_grads": grads["card"]}


def synthesis_card_vs_cpu(cfg, bank, device):
    """(c) The same draws rendered on the card (``asm_dynamic``) and on the
    CPU (``torch.fft``), B = the flagship's."""
    draws = synth.draw_batch(synth.stream_generator(cfg.data.seed, 0), len(bank), cfg.data)
    asm_cuda.reset_launches()
    card = synth.render_batch(torch.as_tensor(bank, device=device), draws, cfg.data, cfg.physics,
                              return_gt=True)
    torch.cuda.synchronize()
    launches = dict(asm_cuda.LAUNCHES)
    cpu = synth.render_batch(torch.as_tensor(bank), draws, cfg.data, cfg.physics, return_gt=True)
    if launches["asm_dynamic"] != 2:
        _die(f"the synthesis launched {launches}, want 2 asm_dynamic", 1)
    errs = {k: rel_err(card[k].cpu(), cpu[k]) for k in cpu}
    tols = {k: SYNTH_TOL if k.endswith("holo") else SYNTH_OBJECT_TOL for k in cpu}
    if not all(errs[k] < tols[k] for k in errs):
        _die(f"the synthesis on the card and the CPU differ: {errs}", 1)
    return {"B": cfg.data.batch_size, "launches": launches, "rel_err": errs, "tol": tols}


def ring_gradients(layers, device, b: int = RING_GRAD_BATCH) -> list:
    """(d) The gradients of a ReflectConv through the ``cuda`` ring (the
    kernel forward, the plain version's VJP backward) against ``matpad``
    and ``einsum`` autograd, x, weight and bias, at each distinct layer
    ``(C, H, W, O)`` of a step, on the card."""
    rows = []
    for c, h, w, o in sorted(set(map(tuple, layers))):
        g = torch.Generator().manual_seed(c + h + o)
        conv = ReflectConv(c, o)
        with torch.no_grad():
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * (2.0 / (9 * c)) ** 0.5)
            conv.bias.copy_(0.1 * torch.randn(o, generator=g))
        conv = conv.to(device)
        x = torch.randn(b, c, h, w, generator=g).to(device).requires_grad_()
        up = torch.randn(b, o, h, w, generator=g).to(device)
        grads = {}
        for backend in ("cuda", "matpad", "einsum"):
            set_reflect_backend(backend)
            y = conv(x)
            grads[backend] = torch.autograd.grad((y * up).sum(), (x, conv.weight, conv.bias))
        set_reflect_backend("auto")
        torch.cuda.synchronize()
        row = {"layer": [c, h, w, o], "B": b, "tol": RING_GRAD_TOL}
        for ref in ("matpad", "einsum"):
            row[f"rel_err_vs_{ref}"] = max(rel_err(a, r) for a, r in zip(grads["cuda"], grads[ref]))
        rows.append(row)
        if not all(row[f"rel_err_vs_{ref}"] < RING_GRAD_TOL for ref in ("matpad", "einsum")):
            _die(f"the ring's gradient check failed: {json.dumps(row)}", 1)
    return rows


def train_step_ring(cfg, cmp, device) -> dict:
    """(d) One train step with the ``cuda`` ring against ``matpad``, on the
    card, from (b)'s params and batch: aux, the ring path's gradients against
    (b)'s float64 ones, the updated states; the ring's launches in the step."""
    small = _train_cfg(cfg, batch_size=TRAIN_CMP_BATCH)
    args = (small, cmp["params"], cmp["disc_params"], cmp["batch"], device)
    reflect_border.reset_launches()
    ring_state, ring_aux = one_train_step(*args, backend="cuda")
    torch.cuda.synchronize()
    launches = reflect_border.LAUNCHES["border_lines"]
    matpad_state, matpad_aux = one_train_step(*args, backend="matpad")
    # three encoders (9 reflect convs each) and one decoder (11) a forward
    if launches != 3 * 9 + 11:
        _die(f"the cuda-ring train step launched the ring {launches} times, want 38", 1)
    ring_grads = step_gradients(*args, backend="cuda")
    return {"B": TRAIN_CMP_BATCH, "launches": launches,
            "aux_rel_err": compare_aux(ring_aux, matpad_aux, "train step, cuda ring against matpad"),
            "gradients_vs_float64": check_gradients({"cuda_ring": ring_grads}, cmp["anchor"],
                                                    "train step, cuda ring"),
            "states": compare_states(ring_state, matpad_state, cmp["anchor"], (ring_grads, cmp["card_grads"]),
                                     cfg.train, "train step, cuda ring against matpad")}


def time_train_steps(cfg, bank, device, *, dtype=torch.float32, remat=False, steps=TRAIN_TIMED,
                     warmup=TRAIN_TIMED_WARMUP, lr=None, fixed_batch=False, params=None,
                     disc_params=None) -> dict:
    """``warmup`` + ``steps`` train steps of ``cfg`` from ``params`` (by
    default ``init_net_params`` seed 0) at its width and batch, the net
    computing in ``dtype``, with
    ``remat`` (and ``lr`` for the config's), as ``train()`` runs them: each
    synthesizes a batch, then the generator's gradients, the optimizer and
    EMA and, when adversarial, the discriminator's step. With
    ``fixed_batch`` every step takes its gradients on the stream's batch 0
    (the fresh batch still synthesized and timed). CUDA-event medians of
    the step and its parts over the timed steps, images/s, the peak of
    allocated memory and each step's total loss (all finite, or the run
    fails)."""
    run = dataclasses.replace(cfg.train, remat=remat, lr=cfg.train.lr if lr is None else lr)
    bank_dev = torch.as_tensor(bank, device=device)
    if params is None:
        params = init_net_params(torch.Generator().manual_seed(0), width=cfg.model.width)
    disc = PatchDiscriminator(image_size=cfg.data.image_size).to(device) if run.adv_weight else None
    if disc is None:
        disc_params = None
    elif disc_params is None:
        disc_params = init_params(PatchDiscriminator(image_size=cfg.data.image_size), torch.Generator().manual_seed(1))
    state = create_train_state(params, run, disc_params=disc_params, device=device)
    step = TrainStep(StyleTransferNet(width=cfg.model.width).to(device), cfg.physics, run, disc=disc,
                     dtype=dtype)
    fixed = synth.synth_batch(0, bank_dev, cfg.data, cfg.physics, return_gt=True) if fixed_batch else None
    parts = ("synthesis", "generator", "optimizer_ema") + (("discriminator",) if disc is not None else ())
    times = {k: [] for k in parts + ("step",)}
    losses = []
    step_modules.cache_clear()  # the peak is the step's alone
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(warmup + steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(parts) + 1)]
        ev[0].record()
        batch = synth.synth_batch(i + bool(fixed_batch), bank_dev, cfg.data, cfg.physics,
                                  return_gt=bool(run.supervised_weight))
        batch = fixed if fixed_batch else batch
        ev[1].record()
        grads, aux = step.generator_grads(state, batch)
        ev[2].record()
        step.apply(state, grads)
        ev[3].record()
        if disc is not None:
            step.disc_step(state, aux.pop("g_t"), batch["style_holo"])
            ev[4].record()
        ev[-1].synchronize()
        losses.append(float(aux["loss_total"]))
        if i >= warmup:
            for k, a, z in zip(parts, ev, ev[1:]):
                times[k].append(a.elapsed_time(z))
            times["step"].append(ev[0].elapsed_time(ev[-1]))
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for v in losses):
        _die(f"train steps ({_dt(dtype)}, remat {remat}): a loss is not finite: {losses}", 1)
    ms = {k: float(np.median(v)) for k, v in times.items()}
    return {"dtype": _dt(dtype), "remat": remat, "B": cfg.data.batch_size, "width": cfg.model.width,
            "lr": run.lr, "ms": ms, "images_per_s": cfg.data.batch_size / ms["step"] * 1e3,
            "max_memory_allocated_bytes": peak, "timed_steps": steps, "losses": losses}


def learn_and_time(cfg, bank, device) -> dict:
    """(e) TRAIN_LEARN_STEPS steps on one fixed batch at TRAIN_LEARN_LR from
    ``init_net_params`` seed 0 (``time_train_steps``, the medians after
    TRAIN_WARMUP steps): the total loss must fall."""
    out = time_train_steps(cfg, bank, device, steps=TRAIN_LEARN_STEPS - TRAIN_WARMUP, warmup=TRAIN_WARMUP,
                           lr=TRAIN_LEARN_LR, fixed_batch=True)
    losses = out["losses"]
    head, tail = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not tail < head:
        _die(f"the total loss did not fall over {TRAIN_LEARN_STEPS} steps: {losses}", 1)
    return {**out, "loss_total_first5": head, "loss_total_last5": tail}


def drive_train_w125(bank, device) -> dict:
    """(f) The committed ``w125`` recipe (``checkpoints_w125/config.json``:
    width 1.25, bf16, the warp on, B = 32, 128^2) from ``init_net_params``
    seed 0 through ``train()`` for W125_STEPS steps, the counts reset just
    before and read just after: every loss finite, params and optimizer
    state fp32, ``asm_dynamic`` launched twice a step (the synthesis) and
    nothing else under ``auto``; then TRAIN_TIMED steps timed."""
    with open(W125_CONFIG) as f:
        cfg = ExperimentConfig.from_json(f.read())
    if cfg.model.dtype != "bfloat16" or cfg.model.width != 1.25 or not cfg.data.rotate_deg:
        _die(f"{W125_CONFIG} is not the bf16 width-1.25 warp recipe: {cfg.model}", 1)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_w125_") as tmp:
        run = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, log_every=1, checkpoint_every=0, checkpoint_dir=tmp))
        asm_cuda.reset_launches()
        reflect_border.reset_launches()
        t0 = time.monotonic()
        state = train(run, bank=bank, iterations=W125_STEPS, device=device, log_fn=lambda line: None)
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        launches = {**asm_cuda.LAUNCHES, **reflect_border.LAUNCHES}
        with open(os.path.join(tmp, "train_metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
    if len(rows) != W125_STEPS or not all(math.isfinite(v) for r in rows for v in r.values()):
        _die(f"w125 train(): {len(rows)} metric rows, want {W125_STEPS}, all finite: {rows[-1:]}", 1)
    trees = (state.params, state.opt_state.mu, state.opt_state.nu)
    if not all(v.dtype == torch.float32 and bool(torch.isfinite(v).all()) for t in trees for v in t.values()):
        _die("w125 train(): params or Adam moments not finite fp32", 1)
    want = {"asm_dynamic": 2 * W125_STEPS, "asm_const": 0, "border_lines": 0}
    if launches != want:
        _die(f"w125 train() launched {launches}, want {want}", 1)
    return {"config": os.path.relpath(W125_CONFIG, REPO), "steps": W125_STEPS, "seconds": seconds,
            "launches": launches, "first": rows[0], "last": rows[-1], "cli": cli_train_w125(cfg),
            "timed": time_train_steps(cfg, bank, device, dtype=torch.bfloat16)}


def cli_train_w125(cfg) -> dict:
    """``cli train --dtype bfloat16`` on the card with the ``w125`` recipe's
    batch, warp and loss weights (the CLI trains width 1.0) for W125_STEPS
    steps: every logged loss finite, ``asm_dynamic`` twice a step, the
    saved params fp32."""
    d, t = cfg.data, cfg.train
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_w125_") as tmp:
        asm_cuda.reset_launches()
        run_cli(["train", "--dtype", "bfloat16", "--iterations", str(W125_STEPS), "--batch-size",
                 str(d.batch_size), "--bank", "golden", "--checkpoint-dir", tmp, "--log-every", "1",
                 "--checkpoint-every", "0", "--rotate-deg", str(d.rotate_deg), "--elastic-px", str(d.elastic_px),
                 "--lr", str(t.lr), "--supervised-weight", str(t.supervised_weight), "--physics-weight",
                 str(t.physics_weight), "--distance-weight", str(t.distance_weight), "--adv-weight",
                 str(t.adv_weight), "--train-encoder"])
        torch.cuda.synchronize()
        launches = dict(asm_cuda.LAUNCHES)
        with open(os.path.join(tmp, "train_metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        params = load_train_params(latest_snapshot(tmp))
    if (len(rows) != W125_STEPS or not all(math.isfinite(v) for r in rows for v in r.values())
            or launches["asm_dynamic"] != 2 * W125_STEPS
            or not all(v.dtype == torch.float32 for v in params.values())):
        _die(f"cli train --dtype bfloat16: {len(rows)} rows, launches {launches}, "
             f"param dtypes {sorted({str(v.dtype) for v in params.values()})}: {rows[-1:]}", 1)
    return {"steps": W125_STEPS, "launches": launches, "last": rows[-1]}


@contextlib.contextmanager
def checking_ring():
    """Within the block, every ``reflect_border.border_lines`` call (the
    reflect convs look it up at each call) runs the op, then holds its rows
    and columns to ``border_lines_plain`` on the same inputs in units of one
    bf16 ulp of the plain output's max; the list this yields gets one row a
    call: the layer and its readings."""
    rows = []
    ring = reflect_border.border_lines

    def checked(x, k):
        out = ring(x, k)
        with torch.no_grad():
            ref = reflect_border.border_lines_plain(x.detach(), k.detach())
            err = max(float((a.float() - r.float()).abs().max()) / bf16_ulp(r.float()) for a, r in zip(out, ref))
        rows.append({"layer": [x.shape[1], x.shape[2], x.shape[3], k.shape[0]], "dtype": _dt(x.dtype),
                     "ulps": err})
        return out

    reflect_border.border_lines = checked
    try:
        yield rows
    finally:
        reflect_border.border_lines = ring


def grad_distances(grads: dict, anchor: dict) -> dict:
    """Each leaf's L2 distance from the float64 ``anchor``'s over the
    anchor leaf's norm: {group/leaf: relative distance} (leaves whose float64
    gradient is zero left out)."""
    out = {}
    for group, want in anchor.items():
        for k, w in want.items():
            norm = float(w.norm())
            if norm > 0:
                out[f"{group}/{k}"] = float((grads[group][k] - w).norm()) / norm
    return out


def bf16_distance_shares(path: list, yardstick: list) -> dict:
    """``path``'s relative distances from float64 (``grad_distances``, one
    dict a batch) against ``yardstick``'s, the generator's leaves in two
    groups. The decoder's: each leaf's median over the batches within
    BF16_GRAD_RATIO times the yardstick's plus BF16_GRAD_SLACK. The encoder's
    and the distance head's, whose distances carry one ill-conditioned
    factor a batch (the physics loss's gradient through the distance head):
    the median over those leaves of the two paths' ratio, its median over
    the batches within BF16_GRAD_RATIO. Each group's worst share of its
    bound."""
    dec = [k for k in path[0] if k.startswith("params/decoder.")]
    enc = [k for k in path[0] if k.startswith("params/") and k not in dec]
    shares = {k: float(np.median([d[k] for d in path]))
              / (BF16_GRAD_RATIO * float(np.median([d[k] for d in yardstick])) + BF16_GRAD_SLACK) for k in dec}
    worst = max(shares, key=shares.get)
    ratios = [float(np.median([p[k] / y[k] for k in enc])) for p, y in zip(path, yardstick)]
    return {"decoder": {"worst_share_of_bound": shares[worst], "leaf": worst,
                        "top": dict(sorted(shares.items(), key=lambda kv: -kv[1])[:3])},
            "encoder_head": {"share_of_bound": float(np.median(ratios)) / BF16_GRAD_RATIO,
                             "median_ratio_by_batch": ratios}}


def check_bf16_distances(path: list, yardstick: list, label: str) -> dict:
    """``bf16_distance_shares`` within their bounds, or the run fails."""
    out = bf16_distance_shares(path, yardstick)
    if not (out["decoder"]["worst_share_of_bound"] <= 1.0 and out["encoder_head"]["share_of_bound"] <= 1.0):
        _die(f"{label}: gradients off the float64 ones: {json.dumps(out)}", 1)
    return out


class _OneBitCoarser(torch.autograd.Function):
    """A bf16 tensor rounded to 7 significant bits (bf16 keeps 8), and the
    gradient into it too."""

    @staticmethod
    def forward(ctx, x):
        return _round_7_bits(x)

    @staticmethod
    def backward(ctx, g):
        return _round_7_bits(g)


def _round_7_bits(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.bfloat16:
        return x
    i = x.float().view(torch.int32)
    return ((i + (1 << 16)) & -(1 << 17)).view(torch.float32).to(torch.bfloat16)


@contextlib.contextmanager
def one_bit_coarser_convs():
    """Within the block every bf16 conv of ``models/layers.py`` (``conv_in_dtype``)
    one bit coarser than bf16, forward and backward: the gradient check's
    control."""
    conv = layers.conv_in_dtype
    layers.conv_in_dtype = lambda *a, **k: _OneBitCoarser.apply(conv(*a, **k))
    try:
        yield
    finally:
        layers.conv_in_dtype = conv


def train_bf16_card_vs_cpu(cfg, bank, cmp, device) -> dict:
    """(g) Mixed precision at the flagship's configuration, B =
    TRAIN_CMP_BATCH, from (b)'s params: the bf16 step's loss and terms on
    the card against the CPU's on (b)'s batch (within BF16_AUX_RTOL); on
    BF16_GRAD_BATCHES batches (the first (b)'s) the bf16 gradients of the
    card (``matpad``), of the CPU, of the card with the ``cuda`` ring, and
    of the control (the card's step one bit coarser,
    ``one_bit_coarser_convs``) against float64 ones on the card: the card's
    held to the CPU's and the ring's to the card's ``matpad``
    (``check_bf16_distances``), the control must fail the check, and the
    fp32 discriminator's gradients within TRAIN_GRAD_TOL of float64. The
    ring launched at each of a step's reflect convs, each call's output
    within one bf16 ulp of its plain version's max."""
    small = _train_cfg(cfg, batch_size=TRAIN_CMP_BATCH)
    params, disc_params = cmp["params"], cmp["disc_params"]
    bf16 = torch.bfloat16
    paths = ("card", "cpu", "cuda_ring", "control")
    dist = {p: [] for p in paths}
    aux = {p: {} for p in paths}
    disc, launches, ring_calls, seconds = {}, [], [], {}
    for i in range(BF16_GRAD_BATCHES):
        batch = cmp["batch"] if i == 0 else synth.synth_batch(i, torch.as_tensor(bank), small.data, cfg.physics,
                                                              return_gt=True)
        args = (small, params, disc_params, batch)
        anchor = cmp["anchor"] if i == 0 else step_gradients(*args, device, torch.float64)
        for path in paths:
            t0 = time.monotonic()
            reflect_border.reset_launches()
            ring = checking_ring() if path == "cuda_ring" else contextlib.nullcontext([])
            control = one_bit_coarser_convs() if path == "control" else contextlib.nullcontext()
            with ring as calls, control:
                grads = step_gradients(*args, "cpu" if path == "cpu" else device,
                                       backend="cuda" if path == "cuda_ring" else "auto", compute=bf16,
                                       aux_out=aux[path] if i == 0 else None)
                torch.cuda.synchronize()
            seconds[path] = seconds.get(path, 0.0) + time.monotonic() - t0
            dist[path].append(grad_distances(grads, anchor))
            if path == "cuda_ring":
                launches.append(reflect_border.LAUNCHES["border_lines"])
                ring_calls += calls
            if path != "control":
                disc.update(check_gradients({f"{path}_batch{i}": grads}, {"disc_params": anchor["disc_params"]},
                                            "bf16 steps, the fp32 discriminator"))
    worst_ulps = max(r["ulps"] for r in ring_calls)
    if (any(n != REFLECT_STEP_CONVS for n in launches) or len(ring_calls) != REFLECT_STEP_CONVS * BF16_GRAD_BATCHES
            or worst_ulps > 1.0 or any(r["dtype"] != "bfloat16" for r in ring_calls)):
        _die(f"the bf16 ring steps launched {launches} rings ({len(ring_calls)} checked, want "
             f"{REFLECT_STEP_CONVS} a step in bf16), worst {worst_ulps} bf16 ulps off the plain version", 1)
    control = bf16_distance_shares(dist["control"], dist["cpu"])
    if not control["decoder"]["worst_share_of_bound"] > 1.0:
        _die(f"the bf16 gradient check passes a path one bit coarser than bf16: {json.dumps(control)}", 1)
    return {"B": TRAIN_CMP_BATCH, "batches": BF16_GRAD_BATCHES, "seconds_by_path": seconds,
            "aux_rel_err": compare_aux(aux["card"], aux["cpu"], "one bf16 step, card against CPU", BF16_AUX_RTOL),
            "card_vs_cpu": check_bf16_distances(dist["card"], dist["cpu"], "bf16 steps, the card"),
            "ring_vs_matpad": check_bf16_distances(dist["cuda_ring"], dist["card"], "bf16 steps, the cuda ring"),
            "control_vs_cpu": control, "disc_params_vs_float64": disc,
            "ring_launches": launches[0], "ring_worst_bf16_ulps": worst_ulps,
            "ring_layers": [tuple(r["layer"]) for r in ring_calls[:REFLECT_STEP_CONVS]],
            "tols": {"aux_rtol": BF16_AUX_RTOL, "grad_ratio": BF16_GRAD_RATIO, "grad_slack": BF16_GRAD_SLACK},
            "rel_distances": dist}


def max_rel_difference(a: dict, b: dict) -> float:
    """The largest |a - b| of any leaf of ``step_gradients``'s trees over
    that leaf's max |b|."""
    return max(float((a[g][k] - b[g][k]).abs().max()) / max(float(b[g][k].abs().max()), 1e-30)
               for g in b for k in b[g])


@contextlib.contextmanager
def deterministic_algorithms():
    """``torch.use_deterministic_algorithms`` within the block."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def remat_against_plain(cfg, bank, cmp, device, dtype, backend) -> dict:
    """(h) ``remat`` at the flagship's configuration and batch with dropout
    on, from (b)'s params on the stream's batch 0, the net computing in
    ``dtype`` with the reflect ``backend``, under
    ``torch.use_deterministic_algorithms``: the gradients of
    REMAT_PLAIN_STEPS plain steps and one ``remat`` step, and the ring's
    launches in each. The ``remat`` step's largest difference from the
    first plain step (``max_rel_difference``) within REMAT_SPREAD times the
    plain steps' spread. In that mode plain steps repeat bit for bit, so
    the ``remat`` step must equal them: its recompute gives the forward's
    activations bit for bit. Without it any two steps, plain or not, part
    by the backward's atomic adds."""
    run = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, use_dropout=True))
    batch = synth.synth_batch(0, torch.as_tensor(bank, device=device), cfg.data, cfg.physics, return_gt=True)
    grads, launches = [], []
    with deterministic_algorithms():
        for remat in (False,) * REMAT_PLAIN_STEPS + (True,):
            reflect_border.reset_launches()
            grads.append(step_gradients(dataclasses.replace(run, train=dataclasses.replace(run.train, remat=remat)),
                                        cmp["params"], cmp["disc_params"], batch, device, backend=backend,
                                        compute=dtype, host=False))
            torch.cuda.synchronize()
            launches.append(reflect_border.LAUNCHES["border_lines"])
    plain = grads[:-1]
    spread = max(max_rel_difference(a, b) for i, b in enumerate(plain) for a in plain[i + 1:])
    diff = max_rel_difference(grads[-1], plain[0])
    out = {"dtype": _dt(dtype), "backend": backend, "B": cfg.data.batch_size, "plain_steps": REMAT_PLAIN_STEPS,
           "plain_spread": spread, "remat_vs_plain": diff, "bound": REMAT_SPREAD * spread,
           "ring_launches": {"plain": launches[0], "remat": launches[-1]}}
    if not diff <= REMAT_SPREAD * spread:
        _die(f"a remat step against plain steps ({_dt(dtype)}, {backend}): {json.dumps(out)}", 1)
    return out


def drive_train_mixed(cfg, bank, cmp, fp32_timed, device, peak_flops, peak_bytes) -> dict:
    """(g) and (h): the bf16 step against the CPU and float64, ``remat``
    against plain steps in fp32 (``auto``) and bf16 (the ``cuda`` ring, its
    launches with and without ``remat``), the flagship's steps timed in
    bf16 and with ``remat`` (fp32 without it is (e)'s), and the bf16 ring at
    each of the training step's reflect convs; each part's seconds."""
    seconds, t0 = {}, time.monotonic()
    ring_cmp = train_bf16_card_vs_cpu(cfg, bank, cmp, device)
    seconds["g"], t0 = time.monotonic() - t0, time.monotonic()
    remat = {f"{_dt(dt)}_{be}": remat_against_plain(cfg, bank, cmp, device, dt, be)
             for dt, be in ((torch.float32, "auto"), (torch.bfloat16, "cuda"))}
    launches = remat["bfloat16_cuda"]["ring_launches"]
    if launches["plain"] != REFLECT_STEP_CONVS or not launches["plain"] < launches["remat"] <= 2 * launches["plain"]:
        _die(f"the bf16 cuda-ring steps launched {launches}: want {REFLECT_STEP_CONVS} a plain step and "
             "more, up to twice that, with remat (its recompute)", 1)
    seconds["remat"], t0 = time.monotonic() - t0, time.monotonic()
    timed = {"float32": {k: fp32_timed[k] for k in ("dtype", "remat", "B", "ms", "images_per_s",
                                                    "max_memory_allocated_bytes", "timed_steps")}}
    for dtype, remat_on in ((torch.bfloat16, False), (torch.float32, True), (torch.bfloat16, True)):
        timed[f"{_dt(dtype)}{'_remat' if remat_on else ''}"] = time_train_steps(
            cfg, bank, device, dtype=dtype, remat=remat_on, steps=REMAT_TIMED, warmup=REMAT_WARMUP,
            params=cmp["params"], disc_params=cmp["disc_params"])
    seconds["timed"], t0 = time.monotonic() - t0, time.monotonic()
    ring_step = time_ring_step(ring_cmp.pop("ring_layers"), peak_flops, peak_bytes, cfg.data.batch_size, device,
                               dtype=torch.bfloat16, plain=True)
    seconds["ring_step"] = time.monotonic() - t0
    return {"bf16_card_vs_cpu": ring_cmp, "remat_against_plain": remat, "ring_launches": launches,
            "timed": timed, "ring_bf16_step": ring_step, "seconds": seconds}


def gloo_support(device) -> dict:
    """Each collective of the mesh layer on a small tensor on ``device`` in
    this rank's world: "ok" or the first line of its error; ``all_to_all``
    and ``ppermute`` are the mesh layer's (``all_to_all_single`` with even
    and uneven splits). (send/recv, which the mesh layer does not use, is
    left out: on CUDA tensors gloo aborts the process there;
    scripts/port_probe_gloo_cuda.py tries each collective in a world of its
    own, scripts/port_probe_gloo_a2a.py each split.)"""
    world = torch.distributed.group.WORLD
    n, r = torch.distributed.get_world_size(), torch.distributed.get_rank()
    x = torch.arange(2.0 * n, device=device)
    ops = {
        "all_reduce": lambda: parallel.mesh.all_reduce(x.clone(), world),
        "all_gather": lambda: parallel.mesh.all_gather(x, 0, world),
        "reduce_scatter": lambda: parallel.mesh.reduce_scatter(x, 0, world),
        "broadcast": lambda: torch.distributed.broadcast(x.clone(), 0),
        "all_to_all": lambda: parallel.mesh.all_to_all(x.reshape(n, 2), 0, 1, world),
        # uneven: rank 0's 3 elements to rank 1 alone, nothing back
        "ppermute": lambda: parallel.mesh.ppermute(x[:3] if r == 0 else x[:0], [(0, 1)], world,
                                                   (3,) if r == 1 else (0,)),
        "barrier": lambda: torch.distributed.barrier(),
    }
    out = {}
    for name, op in ops.items():
        try:
            op()
            torch.cuda.synchronize() if device.type == "cuda" else None
            out[name] = "ok"
        except RuntimeError as e:
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    return out


def parallel_step_pair(cfg, params, bank, device, mesh=None, partition="dp", rank=0):
    """PARALLEL_STEPS train steps from ``params`` on the stream's first
    batches, the reflect backend ``cuda``: on a mesh in this rank, on its
    shards and rows. Returns the first step's aux, its whole gradients and
    the whole params after it, every step's aux and seconds, and the
    kernels' launches of the steps (the synthesis included)."""
    set_reflect_backend("cuda")
    state = create_train_state(params, cfg.train, device=device)
    plan, rows = None, None
    if mesh is not None:
        plan = parallel.partition_state_shardings(partition, state, mesh)
        state = parallel.shard_state(state, plan, rank)
        rows = parallel.local_rows(cfg.data.batch_size, mesh, rank)
    sampler = synth.InfiniteHologramSampler(bank, cfg.data, cfg.physics, return_gt=True, device=device,
                                            rows=rows)
    step = TrainStep(StyleTransferNet(width=cfg.model.width).to(device), cfg.physics, cfg.train,
                     mesh=mesh, state_shardings=plan)
    asm_cuda.reset_launches()
    reflect_border.reset_launches()
    out = {"aux": [], "seconds": []}
    for i in range(PARALLEL_STEPS):
        batch = next(sampler)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads, aux = step.generator_grads(state, batch)
        step.apply(state, grads)
        aux.pop("g_t")
        if device.type == "cuda":
            torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - t0)
        out["aux"].append({k: float(v) for k, v in aux.items()})
        if i == 0:
            # copies: the next step updates the state in place
            out["grads"] = {k: v.to("cpu", copy=True) for k, v in parallel.gather_state(
                grads, None if plan is None else plan.opt_state.mu).items()}
            whole = state if plan is None else parallel.gather_state(state, plan)
            out["params"] = {k: v.to("cpu", copy=True) for k, v in whole.params.items()}
    out["launches"] = {**asm_cuda.LAUNCHES, **reflect_border.LAUNCHES}
    set_reflect_backend("auto")
    return out


def _reset_counts() -> None:
    """The mesh layer's collective counts and every kernel's launches to 0."""
    parallel.mesh.reset_collective_counts()
    asm_cuda.reset_launches()
    reflect_border.reset_launches()


def _counts() -> dict:
    """The collectives' calls and the bytes this rank sent, and the kernels'
    launches, since ``_reset_counts``."""
    return {"calls": dict(parallel.mesh.COLLECTIVE_CALLS), "bytes": dict(parallel.mesh.COLLECTIVE_BYTES),
            "launches": {**asm_cuda.LAUNCHES, **reflect_border.LAUNCHES}}


def _timed(fn):
    """(fn(), its seconds), the card synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def sharded_refocus_field(device) -> torch.Tensor:
    """PP_FIELD's complex64 field: real and imaginary parts uniform in
    [0, 1) from a seeded generator on ``device`` (the same on every rank)."""
    g = torch.Generator(device=device).manual_seed(7)
    re = torch.rand(PP_FIELD, generator=g, device=device)
    return torch.complex(re, torch.rand(PP_FIELD, generator=g, device=device))


def check_sharded_refocus(mesh, physics, device, axis: str = parallel.DATA_AXIS) -> dict:
    """``sharded_propagate`` on this rank's rows of ``sharded_refocus_field``
    for each PP_FIELD_CASES case, against ``propagate_torch`` of the whole
    field on this card: the error over this rank's rows relative to the
    reference's max, the seconds of two sharded calls and two one-device
    calls (the first of each plans cuFFT's transforms), and a sharded
    call's collectives and launches (``_counts``)."""
    field = sharded_refocus_field(device)
    n = mesh.shape[axis]
    r = mesh.coords(torch.distributed.get_rank())[axis]
    rows = slice(r * PP_FIELD[-2] // n, (r + 1) * PP_FIELD[-2] // n)
    mine = field[..., rows, :].contiguous()
    kw = dict(wavelength=physics.wavelength, pixel_size=physics.pixel_size)
    out = {}
    for name, (dists, extra) in PP_FIELD_CASES.items():
        d = torch.tensor(dists, device=device).reshape(-1, 1, 1, 1)
        sharded, one = [], []
        for _ in range(2):
            _reset_counts()
            got, sec = _timed(lambda: parallel.sharded_propagate(mine, d, mesh=mesh, axis=axis, **kw, **extra))
            sharded.append(sec)
            counts = _counts()
            ref, sec = _timed(lambda: propagate_torch(field, d, **kw, **extra))
            one.append(sec)
        err = float((got - ref[..., rows, :]).abs().max() / ref.abs().max())
        out[name] = {"rel_err": err, "sharded_seconds": sharded, "one_device_seconds": one, **counts}
    return out


def pipeline_inputs() -> dict:
    """The pipeline's retrieval inputs: the golden suite's first
    PP_RETRIEVAL_BATCH holograms and its style vector."""
    goldens = load_golden_suite()
    return {"holo": goldens.content_holo.reshape(-1, 1, IMAGE, IMAGE)[:PP_RETRIEVAL_BATCH],
            "sm": goldens.style_mean, "ss": goldens.style_std}


def pipeline_disc(device):
    """The flagship's discriminator and its seed-1 weights on ``device``."""
    disc = PatchDiscriminator(image_size=IMAGE)
    return disc.to(device), {k: v.to(device) for k, v in init_params(disc, torch.Generator().manual_seed(1)).items()}


def _pipeline_steps(step, state) -> dict:
    """PP_STEPS steps of a pipeline step function (``step(state,
    with_grads)``): each step's aux and seconds, the first step's gradients
    of this rank's stage, a step's collectives and launches."""
    _reset_counts()
    out = {"aux": [], "seconds": []}
    start = state
    for i in range(PP_STEPS):
        res, sec = _timed(lambda: step(state, i == 0))
        state, aux = res[0], res[1]
        out["seconds"].append(sec)
        out["aux"].append({k: float(v) for k, v in aux.items()})
        if i == 0:
            out["grads"] = {k: v.cpu() for k, v in res[2].items()}
            out.update(_counts())
    if len(state) > 4:
        out["disc_moved"] = max(float((state[4][k] - start[4][k]).abs().max()) for k in start[4])
    return out


def pipeline_parts(cfg, params, pp, device_name) -> dict:
    """This rank's side of the pipeline on a ``pipe`` mesh of the whole
    world: the retrieval (the output and its seconds), then PP_STEPS
    fine-tune and full-training steps (``_pipeline_steps``) on ``pp``'s
    batch, the adversarial term at ``pp``'s weight; each part's collectives
    and launches."""
    device = torch.device(device_name)
    n = torch.distributed.get_world_size()
    mesh = parallel.make_mesh(devices=[device_name] * n, axis_names=(parallel.PIPE_AXIS,))
    physics, width = cfg.physics, cfg.model.width
    inp = pipeline_inputs()
    fn = parallel.make_pipeline_retrieval_fn(params, mesh, n_micro=PP_RETRIEVAL_MICRO, image_size=IMAGE,
                                             physics=physics, width=width)
    _reset_counts()
    res, sec = _timed(lambda: fn(inp["holo"], inp["sm"], inp["ss"], PP_D_STYLE))
    out = {"retrieval": {"out": {k: v.cpu() for k, v in res.items()}, "seconds": sec, "stages": fn.stages,
                         **_counts()}}
    batch = pp["batch"]
    step, state = parallel.make_pipeline_finetune_fn(params, mesh, n_micro=PP_TRAIN_MICRO, image_size=IMAGE,
                                                     physics=physics, lr=PP_LR, width=width)
    out["finetune"] = _pipeline_steps(lambda st, g: step(st, batch, inp["sm"], inp["ss"], with_grads=g), state)
    disc, disc_params = pipeline_disc(device)
    train_cfg = dataclasses.replace(cfg.train, adv_weight=float(pp["adv_weight"]))
    step, state = parallel.make_pipeline_train_fn(params, mesh, n_micro=PP_TRAIN_MICRO, image_size=IMAGE,
                                                  physics=physics, cfg=train_cfg, lr=PP_LR, width=width,
                                                  disc=disc, disc_params=disc_params)
    out["train"] = _pipeline_steps(lambda st, g: step(st, batch, with_grads=g), state)
    return out


def parallel_rank(rank, cfg, params, bank, device_name, t_launch, want_path, go):
    """One rank of the phase's gloo world. Started before the phase (after
    ``conv_kernels``), it first pays a process's cold start off the clock of the
    measured steps, with one-process steps at its share of the batch:
    torch's import of ``torch._dynamo`` (at the first call of any
    ``torch.library`` op), the CUDA context and cuDNN's choices; then it
    waits for ``go``. Then the collectives gloo carries on ``device_name``, and
    each partition of PARALLEL_PARTITIONS whose collectives it carries
    (``parallel_step_pair``); the others named with their errors. Rank 0
    holds each partition's whole first step against the one-process step
    saved at ``want_path`` (``parallel_step_distances``); every rank returns
    its launches and the seconds from the launch through each part."""
    device = torch.device(device_name)
    n = torch.distributed.get_world_size()
    # one-process steps at the rank's share of the batch: the imports, the
    # CUDA context and cuDNN's choices for these shapes, off the clock
    parallel_step_pair(_train_cfg(cfg, batch_size=cfg.data.batch_size // n), params, bank, device)
    seconds = {"warm": time.time() - t_launch}
    if not go.wait(TOTAL_BUDGET_S):
        raise TimeoutError("the parallel phase never released the world")
    t0 = time.time()
    seconds["released"] = t0 - t_launch
    want = torch.load(want_path, weights_only=True) if rank == 0 else None
    pp = torch.load(os.path.join(os.path.dirname(want_path), "pp.pt"), weights_only=True)
    support = gloo_support(device)
    out = {"support": support, "partitions": {}, "seconds": seconds}
    for name, (axes, shape) in PARALLEL_PARTITIONS.items():
        refused = {op: support[op] for op in PARALLEL_NEEDS[name] if support[op] != "ok"}
        if refused:
            out["partitions"][name] = {"skipped": refused}
            continue
        mesh = parallel.make_mesh(devices=[device_name] * n, axis_names=axes, shape=shape)
        t = time.time()
        res = parallel_step_pair(cfg, params, bank, device, mesh, name, rank)
        seconds[name] = time.time() - t
        if rank == 0:
            res["vs_one_process"] = parallel_step_distances(res, want, cfg)
        res.pop("grads")
        res.pop("params")
        out["partitions"][name] = res
    # the FOV-sharded refocus and the pipeline, each skipped (and named with
    # gloo's error) where gloo refuses a collective it takes
    parts = {"sharded_refocus": (("all_to_all",), lambda: check_sharded_refocus(
                 parallel.make_mesh(devices=[device_name] * n), cfg.physics, device)),
             "pipeline": (("ppermute", "broadcast"), lambda: pipeline_parts(cfg, params, pp, device_name))}
    for name, (needs, run) in parts.items():
        refused = {op: support[op] for op in needs if support[op] != "ok"}
        if refused:
            out[name] = {"skipped": refused}
            continue
        t = time.time()
        out[name] = run()
        seconds[name] = time.time() - t
    seconds["work"] = time.time() - t0
    return out


class ParallelWorld:
    """The parallel phase's 2-rank gloo world on ``cuda:0`` (``parallel_rank``),
    launched in a daemon thread once every kernel is built so that its ranks'
    cold start overlaps the phases before its own; ``release`` hands it the
    one-process step and lets it run, ``join`` waits for its ranks."""

    def __init__(self, cfg, params, bank, device_name: str = "cuda:0"):
        ctx = torch.multiprocessing.get_context("spawn")
        self.device_name = device_name
        self.mesh = parallel.make_mesh(devices=[device_name] * 2)
        self.go = ctx.Event()
        self.tmp = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
        self.want_path = os.path.join(self.tmp, "want.pt")
        self.t_launch = time.time()
        self.ranks, self.error = None, None
        self.thread = threading.Thread(target=self._run, args=(cfg, params, bank), daemon=True)
        self.thread.start()

    def _run(self, cfg, params, bank):
        try:
            self.ranks = parallel.launch(parallel_rank, self.mesh, cfg, params, bank, self.device_name,
                                         self.t_launch, self.want_path, self.go,
                                         timeout=TOTAL_BUDGET_S + PARALLEL_TIMEOUT_S)
        except (RuntimeError, TimeoutError) as e:
            self.error = e

    def release(self, want, pp) -> None:
        torch.save({k: want[k] for k in ("aux", "grads", "params")}, self.want_path)
        torch.save(pp, os.path.join(self.tmp, "pp.pt"))
        self.go.set()

    def join(self):
        self.thread.join(PARALLEL_TIMEOUT_S)
        shutil.rmtree(self.tmp, ignore_errors=True)
        if self.thread.is_alive() or self.error is not None or self.ranks is None:
            _die(f"the parallel phase's gloo world failed: {self.error or 'no result in time'}", 1)
        return self.ranks


def parallel_step_distances(got, want, cfg) -> dict:
    """A mesh's first step against the one-process step: the aux's relative
    error, the whole gradients' and the params' worst shares of their bounds
    (the phase's rules, PARALLEL_* above; ``check_parallel_step`` holds
    them). Computed in the rank that holds the whole state."""
    aux_err = max(abs(got["aux"][0][k] - v) / max(abs(v), 1e-30) for k, v in want["aux"][0].items())
    if set(got["aux"][0]) != set(want["aux"][0]):
        aux_err = math.inf
    g_share, p_share = {}, {}
    g_all = want["grads"]
    norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in g_all.values()))
    clip = min(1.0, cfg.train.grad_clip_norm / norm) if cfg.train.grad_clip_norm else 1.0
    for k, g in g_all.items():
        noise = float((got["grads"][k] - g).abs().max())
        g_share[k] = noise / max(float(g.abs().max()), 1e-30) / PARALLEL_GRAD_TOL
        spread = adam_first_step_spread(clip * g.double(), clip * noise, cfg.train.lr)
        floor = TRAIN_LEAF_TOL * float(want["params"][k].abs().max())
        d = (got["params"][k].double() - want["params"][k].double()).abs()
        p_share[k] = float((d / (floor + spread).clamp_min(1e-30)).max())
    result = {"aux_rel_err": aux_err,
              "grad_worst_share_of_tol": max(g_share.values()),
              "grad_worst_leaf": max(g_share, key=g_share.get),
              "params_worst_share_of_bound": max(p_share.values()),
              "params_worst_leaf": max(p_share, key=p_share.get),
              "params_max_abs_diff": max(float((got["params"][k] - want["params"][k]).abs().max())
                                         for k in want["params"])}
    return result


def check_parallel_step(result: dict, label: str) -> dict:
    if not (result["aux_rel_err"] < PARALLEL_LOSS_RTOL and result["grad_worst_share_of_tol"] < 1.0
            and result["params_worst_share_of_bound"] < 1.0):
        _die(f"{label}: the step is not the one-process step: {json.dumps(result)}", 1)
    return result


@contextlib.contextmanager
def recording_adam_steps():
    """Every ``Adam.update`` within the block, in order: (the optimizer, the
    params of its names before its first update, the gradients it took),
    float64 copies on their device."""
    calls, seen, update = [], set(), Adam.update

    def recorded(self, grads, state, params, **kw):
        names = list(state.mu)
        start = None if id(self) in seen else {k: params[k].detach().double().clone() for k in names}
        seen.add(id(self))
        calls.append((self, start, {k: grads[k].detach().double().clone() for k in names}))
        return update(self, grads, state, params, **kw)

    Adam.update = recorded
    try:
        yield calls
    finally:
        Adam.update = update


def replay_adam_steps(calls, ema_decay: float) -> dict:
    """``calls`` (``recording_adam_steps``) replayed in float64, each
    optimizer from a fresh state: its names' params after the last call, and
    the EMA of the first optimizer's (the generator's), updated after each
    of its calls as ``train()`` does. {"params" | "disc_params" |
    "ema_params": {name: tensor}}."""
    params, states, order = {}, {}, []
    ema = None
    for tx, start, grads in calls:
        key = id(tx)
        if key not in params:
            params[key] = {k: v.clone() for k, v in start.items()}
            states[key] = tx.init(params[key])
            order.append(key)
            if ema is None and ema_decay:
                ema = {k: v.clone() for k, v in start.items()}
        Adam.update(tx, grads, states[key], params[key])
        if key == order[0] and ema is not None:
            for k, v in params[key].items():
                ema[k].mul_(ema_decay).add_(v, alpha=1.0 - ema_decay)
    out = {"params": params[order[0]], "ema_params": ema}
    if len(order) > 1:
        out["disc_params"] = params[order[1]]
    return out


def hold_train_states(got, want, got_calls, want_calls, train_cfg, label: str) -> dict:
    """``train()`` on a mesh (``got``, its Adam calls ``got_calls``) against
    ``train()`` without one (``want``, ``want_calls``), after the same steps.
    Each optimizer's first gradients within PARALLEL_GRAD_TOL of the leaf's
    max, its later ones within PARALLEL_LATER_GRAD_TOL; every
    element of params, EMA and discriminator within TRAIN_LEAF_TOL of its
    leaf's max plus PARALLEL_SPREAD times the gap that Adam, replayed in
    float64 on each run's own gradients (``replay_adam_steps``), puts between
    the two: Adam's spread over the gradients' measured difference, step by
    step. The worst shares of the bounds."""
    if len(got_calls) != len(want_calls):
        _die(f"{label}: {len(got_calls)} optimizer updates, want {len(want_calls)}", 1)
    grad_shares, seen = [], set()
    for (tx, _, g), (_, _, w) in zip(got_calls, want_calls):
        if set(g) != set(w):
            _die(f"{label}: an update of other names than the run without a mesh", 1)
        tol = PARALLEL_LATER_GRAD_TOL if id(tx) in seen else PARALLEL_GRAD_TOL
        seen.add(id(tx))
        shares = {k: float((g[k] - w[k]).abs().max()) / max(float(w[k].abs().max()), 1e-30) / tol for k in w}
        worst = max(shares, key=shares.get)
        grad_shares.append({"tol": tol, "leaf": worst, "share_of_tol": shares[worst]})
    out = {"grad_shares_by_update": grad_shares}
    if not max(x["share_of_tol"] for x in grad_shares) < 1.0:
        _die(f"{label}: gradients off: {json.dumps(out)}", 1)
    replay_got = replay_adam_steps(got_calls, train_cfg.ema_decay)
    replay_want = replay_adam_steps(want_calls, train_cfg.ema_decay)
    for group in ("params", "ema_params", "disc_params"):
        a, b = getattr(got, group), getattr(want, group)
        if b is None:
            if a is not None:
                _die(f"{label}: {group} where the run without a mesh has none", 1)
            continue
        ra, rb = replay_got.get(group) or {}, replay_want.get(group) or {}
        shares = {}
        for k in b:
            w = b[k].double()
            bound = TRAIN_LEAF_TOL * float(w.abs().max())
            if k in rb:
                bound = bound + PARALLEL_SPREAD * (ra[k] - rb[k]).abs()
            shares[k] = float(((a[k].double() - w).abs() / torch.as_tensor(bound).clamp_min(1e-30)).max())
        worst = max(shares, key=shares.get)
        out[group] = {"worst_share_of_bound": shares[worst], "leaf": worst,
                      "max_abs_diff": max(float((a[k] - b[k]).abs().max()) for k in b)}
        if not shares[worst] < 1.0:
            _die(f"{label}: {group} off: {json.dumps(out[group])}", 1)
    return out


def nccl_world_runs(cfg, bank, device) -> dict:
    """A 1-rank nccl world in this process (``parallel.init_world``) through
    ``train()``, as ``cli train --devices N`` runs each rank: ``dp`` and
    ``tp_fsdp`` on a (1, 1) mesh, PARALLEL_STEPS steps each from seed 0,
    against the same ``train()`` without a mesh: the logged losses within
    PARALLEL_LOSS_RTOL, the states held by ``hold_train_states``."""
    run = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, log_every=1, checkpoint_every=0))
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as tmp:
        def one(name, mesh=None, partition="dp"):
            d = os.path.join(tmp, name)
            r = dataclasses.replace(run, train=dataclasses.replace(run.train, checkpoint_dir=d))
            asm_cuda.reset_launches()
            t0 = time.monotonic()
            with recording_adam_steps() as calls:
                state = train(r, bank=bank, iterations=PARALLEL_STEPS, device=device, mesh=mesh,
                              partition=partition, log_fn=lambda line: None)
            torch.cuda.synchronize()
            seconds = time.monotonic() - t0
            with open(os.path.join(d, "train_metrics.jsonl")) as f:
                rows = [json.loads(line) for line in f]
            return state, calls, rows, seconds, dict(asm_cuda.LAUNCHES)

        ref, ref_calls, ref_rows, ref_s, _ = one("one_process")
        for name, axes, shape in (("dp", ("data",), (1,)), ("tp_fsdp", ("data", "model"), (1, 1))):
            mesh = parallel.make_mesh(axis_names=axes, shape=shape)
            parallel.init_world(mesh, 0, timeout=PARALLEL_TIMEOUT_S)
            try:
                backend = torch.distributed.get_backend()
                state, calls, rows, seconds, launches = one(name, mesh, name)
            finally:
                parallel.close_world()
            if backend != "nccl":
                _die(f"nccl world {name}: the world's backend is {backend}", 1)
            worst = max(compare_aux({k: v for k, v in r.items() if k.startswith("loss_")},
                                    {k: v for k, v in w.items() if k.startswith("loss_")},
                                    f"nccl world {name} step {r['step']}", PARALLEL_LOSS_RTOL)
                        for r, w in zip(rows, ref_rows))
            states = hold_train_states(state, ref, calls, ref_calls, run.train, f"nccl world {name}")
            del calls
            if launches["asm_dynamic"] != 2 * PARALLEL_STEPS:
                _die(f"nccl world {name}: asm_dynamic launched {launches}", 1)
            out[name] = {"backend": backend, "mesh": dict(mesh.shape), "steps": len(rows),
                         "aux_rel_err": worst, "vs_one_process": states,
                         "seconds": seconds, "launches": launches}
        out["one_process_seconds"] = ref_s
    return out


def pipeline_batch(cfg, bank, device) -> dict:
    """The pipeline's training batch (the stream's first at PP_TRAIN_BATCH,
    with the ground truth) on the host, and the flagship's adversarial
    weight: what ``ParallelWorld.release`` hands every rank."""
    data = dataclasses.replace(cfg.data, batch_size=PP_TRAIN_BATCH)
    batch = next(synth.InfiniteHologramSampler(bank, data, cfg.physics, return_gt=True, device=device))
    return {"batch": {k: v.to("cpu", copy=True) for k, v in batch.items()}, "adv_weight": cfg.train.adv_weight}


def finetune_objective(net, batch, style, physics, micro: int) -> dict:
    """The fine-tune's objective (the supervised fields and 10 times the
    content distance's MSE) on the whole batch, its forward taken in
    ``micro`` microbatches (the pipeline's shapes: cuDNN picks its
    algorithms, and so its summation orders, by shape), and its gradient."""
    outs = [net.field_retrieval(c, *style, unknown_distance=True) for c in batch["content_holo"].chunk(micro)]
    amp, ph, d = (torch.cat(x) for x in zip(*outs))
    gt_amp, gt_ph = style_plane_target(batch["amplitude"], batch["phase_content"], batch["distance_style"], physics)
    l_sup = torch.mean((amp - gt_amp) ** 2) + torch.mean((ph - gt_ph / physics.phase_normalize) ** 2)
    l_d = distance_loss(d, batch["distance_content"])
    loss = l_sup + 10.0 * l_d
    names, tensors = zip(*net.named_parameters())
    return {"aux": {"loss_supervised": float(l_sup.detach()), "loss_distance": float(l_d.detach()),
                    "loss_total": float(loss.detach())},
            "grads": dict(zip(names, torch.autograd.grad(loss, tensors)))}


def pipeline_one_process(cfg, params, pp, device) -> dict:
    """The one-process references of the pipeline's parts on the card:
    ``retrieval_step`` with the torch refocus on ``pipeline_inputs``; the
    fine-tune's objective and its gradient (``finetune_objective``, its
    forward in the pipeline's microbatches and in one batch); the
    flagship's generator loss with the adversarial term
    (``pipeline_disc``) on the whole batch and its gradient."""
    physics = cfg.physics
    inp = pipeline_inputs()
    net = StyleTransferNet(width=cfg.model.width).to(device)
    net.load_state_dict(params)
    out = {"retrieval": retrieval_step(net.eval(), inp["holo"], inp["sm"], inp["ss"], PP_D_STYLE, physics,
                                       device=device, asm_backend="torch")}
    batch = {k: v.to(device) for k, v in pp["batch"].items()}
    style = [t.to(device) for t in split_style_vector(np.concatenate([inp["sm"], inp["ss"]]))]
    out["finetune"] = finetune_objective(net, batch, style, physics, PP_TRAIN_MICRO)
    out["finetune_whole_batch"] = finetune_objective(net, batch, style, physics, 1)
    disc, disc_params = pipeline_disc(device)
    train_cfg = dataclasses.replace(cfg.train, adv_weight=float(pp["adv_weight"]))
    whole = {k: v.to(device).requires_grad_(True) for k, v in params.items()}
    loss, aux = generator_loss_fn(whole, batch, net=StyleTransferNet(width=cfg.model.width).to(device),
                                  physics=physics, cfg=train_cfg, disc=disc, disc_params=disc_params)
    out["train"] = {"aux": {k: float(v.detach()) for k, v in aux.items() if k.startswith("loss_")},
                    "grads": dict(zip(whole, torch.autograd.grad(loss, list(whole.values()))))}
    return out


def grad_shares(got: dict, want: dict) -> tuple:
    """(the worst leaf's max |got - want| over its max |want|, in units of
    PARALLEL_GRAD_TOL; that leaf)."""
    shares = {k: float((got[k].to(w.device) - w).abs().max()) / max(float(w.abs().max()), 1e-30)
              / PARALLEL_GRAD_TOL for k, w in want.items()}
    worst = max(shares, key=shares.get)
    return shares[worst], worst


def hold_pipeline_steps(got: dict, want: dict, label: str) -> dict:
    """A pipeline's first step against the one-process objective: each loss
    term within PARALLEL_LOSS_RTOL, the whole gradient (``got['grads']``,
    the stages' joined) within PARALLEL_GRAD_TOL of each leaf's max."""
    first = {k: v for k, v in got["aux"][0].items() if k != "loss_disc"}
    if set(first) != set(want["aux"]):
        _die(f"{label}: loss terms {sorted(first)}, the one-process objective's {sorted(want['aux'])}", 1)
    aux_err = max(abs(first[k] - v) / max(abs(v), 1e-30) for k, v in want["aux"].items())
    if set(got["grads"]) != set(want["grads"]):
        _die(f"{label}: the stages' gradients do not cover the net", 1)
    share, worst = grad_shares(got["grads"], want["grads"])
    result = {"aux_rel_err": aux_err, "grad_worst_share_of_tol": share, "grad_worst_leaf": worst}
    if not (aux_err < PARALLEL_LOSS_RTOL and share < 1.0):
        _die(f"{label}: the first step is not the one-process step: {json.dumps(result)}", 1)
    return result


def hold_retrieval(out: dict, ref: dict, label: str) -> dict:
    """A pipeline retrieval's outputs against ``retrieval_step``'s: the
    fields, the distance and ``amp_foc`` by PP_RETRIEVAL_TOL (each key's max
    |difference|), ``ph_foc`` by the serving mesh's rule (the zero-meaned
    phase within SLICE_PHASE_TOL modulo 2 pi in SLICE_PHASE_FRACTION of
    the pixels, ``compare_outputs``; its max |difference| beside it): on
    seeded weights the refocused field is near zero at many pixels, where
    its angle turns by 1e-2 rad for inputs 1e-10 apart (measured on the
    card: 0.0106 rad, the fields 9e-11 apart)."""
    if set(out) != set(ref):
        _die(f"{label}: keys {sorted(out)}, retrieval_step's {sorted(ref)}", 1)
    diffs = {k: float((out[k].to(ref[k].device) - ref[k]).abs().max()) for k in ref}
    if not all(diffs[k] < tol for k, tol in PP_RETRIEVAL_TOL.items()):
        _die(f"{label}: not retrieval_step's outputs: {json.dumps(diffs)}", 1)
    phase = compare_outputs(out, ref, math.inf, math.inf, SLICE_PHASE_TOL, SLICE_PHASE_FRACTION, label)
    return {"max_abs_diff": diffs, "ph_foc_frac_within_tol_mod_2pi": phase["ph_foc_frac_within_tol_mod_2pi"]}


def hold_sharded_refocus(rows: list, label: str) -> dict:
    """Every rank's ``check_sharded_refocus`` within SHARDED_FFT_TOL."""
    worst = {case: max(r[case]["rel_err"] for r in rows) for case in PP_FIELD_CASES}
    if not all(e < SHARDED_FFT_TOL for e in worst.values()):
        _die(f"{label}: the sharded refocus is not the one-device refocus: {json.dumps(worst)}", 1)
    return {"rel_err": worst, "by_rank": rows}


def hold_gloo_pipeline(ranks, refs) -> dict:
    """The gloo world's sharded refocus and pipeline parts, each held (a
    part gloo refused is named with its error)."""
    out = {}
    if "skipped" in ranks[0]["sharded_refocus"]:
        out["sharded_refocus"] = ranks[0]["sharded_refocus"]
    else:
        out["sharded_refocus"] = hold_sharded_refocus([r["sharded_refocus"] for r in ranks],
                                                      "gloo world sharded refocus")
    if "skipped" in ranks[0]["pipeline"]:
        out["pipeline"] = ranks[0]["pipeline"]
        return out
    parts = [r["pipeline"] for r in ranks]
    rows = {"stages": parts[0]["retrieval"]["stages"],
            "retrieval": {"vs_one_process_by_rank": [hold_retrieval(p["retrieval"]["out"], refs["retrieval"],
                                                                    f"gloo pipeline retrieval rank {i}")
                                                     for i, p in enumerate(parts)],
                          **{k: [p["retrieval"][k] for p in parts] for k in ("seconds", "calls", "bytes",
                                                                             "launches")}}}
    for name in ("finetune", "train"):
        joined = {"aux": parts[0][name]["aux"], "grads": {k: v for p in parts for k, v in p[name]["grads"].items()}}
        rows[name] = {**hold_pipeline_steps(joined, refs[name], f"gloo pipeline {name}"),
                      "aux_by_step": parts[0][name]["aux"],
                      **{k: [p[name].get(k) for p in parts] for k in ("seconds", "calls", "bytes", "launches",
                                                                      "disc_moved")}}
    # not held: the one-process gradient on one batch of PP_TRAIN_BATCH (its
    # distance from the microbatched one is the partition's rounding)
    ft_grads = {k: v for p in parts for k, v in p["finetune"]["grads"].items()}
    rows["finetune"]["whole_batch_grad_share"] = grad_shares(ft_grads, refs["finetune_whole_batch"]["grads"])
    rows["finetune"]["partition_grad_share"] = grad_shares(refs["finetune"]["grads"],
                                                           refs["finetune_whole_batch"]["grads"])
    if not all(m > 0.0 for m in rows["train"]["disc_moved"]):
        _die(f"gloo pipeline train: a rank's discriminator did not move: {rows['train']['disc_moved']}", 1)
    out["pipeline"] = rows
    return out


def nccl_world_pipeline(cfg, params, refs, device) -> dict:
    """The 1-rank nccl world on a (data 1, pipe 1) mesh in this process:
    the 1-shard sharded refocus and the 1-stage pipeline retrieval, held as
    the gloo world's."""
    mesh = parallel.make_mesh(axis_names=(parallel.DATA_AXIS, parallel.PIPE_AXIS), shape=(1, 1))
    parallel.init_world(mesh, 0, timeout=PARALLEL_TIMEOUT_S)
    try:
        backend = torch.distributed.get_backend()
        fft = check_sharded_refocus(mesh, cfg.physics, device)
        inp = pipeline_inputs()
        fn = parallel.make_pipeline_retrieval_fn(params, mesh, n_micro=PP_RETRIEVAL_MICRO, image_size=IMAGE,
                                                 physics=cfg.physics, width=cfg.model.width)
        _reset_counts()
        res, sec = _timed(lambda: fn(inp["holo"], inp["sm"], inp["ss"], PP_D_STYLE))
        counts = _counts()
    finally:
        parallel.close_world()
    if backend != "nccl":
        _die(f"nccl world pipeline: the world's backend is {backend}", 1)
    return {"backend": backend, "sharded_refocus": hold_sharded_refocus([fft], "nccl world sharded refocus"),
            "retrieval": {"vs_one_process": hold_retrieval(res, refs["retrieval"], "nccl pipeline retrieval"),
                          "seconds": sec, **counts}}


def parallel_inputs(cfg):
    """(the gloo world's config, the params): the flagship's at
    PARALLEL_BATCH without the adversarial term, init_net_params seed 0."""
    small = _train_cfg(cfg, batch_size=PARALLEL_BATCH)
    plain = dataclasses.replace(small, train=dataclasses.replace(small.train, adv_weight=0.0))
    return plain, init_net_params(torch.Generator().manual_seed(0), width=cfg.model.width)


def drive_parallel(cfg, bank, world, fast_net, fast_cfg, fast_style, goldens, dev, smi) -> dict:
    """The mesh layer on the card (the parallel phase); ``world`` is the
    ``ParallelWorld`` started before it."""
    small = _train_cfg(cfg, batch_size=PARALLEL_BATCH)
    info = {"card": smi, "B": PARALLEL_BATCH, "width": cfg.model.width}
    info["nccl_1_rank"] = nccl_world_runs(small, bank, dev)

    # The 2-rank gloo world on cuda:0 against the one-process steps.
    plain, params = parallel_inputs(cfg)
    want = parallel_step_pair(plain, params, bank, dev)
    pp = pipeline_batch(cfg, bank, dev)
    t0 = time.time()
    world.release(want, pp)
    ranks = world.join()
    mesh = world.mesh
    gloo = {"backend": parallel.default_backend(mesh), "released_to_joined_seconds": time.time() - t0,
            "rank_seconds": [r["seconds"] for r in ranks],
            "support": ranks[0]["support"],
            "one_process_step_seconds": want["seconds"], "one_process_launches": want["launches"],
            "partitions": {}}
    for name, res in ranks[0]["partitions"].items():
        if "skipped" in res:
            gloo["partitions"][name] = res
            continue
        row = check_parallel_step(res["vs_one_process"], f"gloo world {name}")
        row["step_seconds_rank0"] = res["seconds"]
        row["launches_by_rank"] = [r["partitions"][name]["launches"] for r in ranks]
        for r, launches in enumerate(row["launches_by_rank"]):
            if launches["asm_dynamic"] != 2 * PARALLEL_STEPS or launches["border_lines"] == 0:
                _die(f"gloo world {name} rank {r}: launched {launches}", 1)
        gloo["partitions"][name] = row
    info["gloo_2_ranks_cuda0"] = gloo

    # The sharded refocus and the pipeline against their one-process references.
    t0 = time.time()
    refs = pipeline_one_process(cfg, params, pp, dev)
    info["one_process_references_seconds"] = time.time() - t0
    info["pipeline_gloo_2_ranks_cuda0"] = hold_gloo_pipeline(ranks, refs)
    info["pipeline_nccl_1_rank"] = nccl_world_pipeline(cfg, params, refs, dev)

    # A serving mesh of two positions on cuda:0.
    holo = goldens.content_holo.reshape(-1, 1, IMAGE, IMAGE)[50:50 + PARALLEL_SERVE_BATCH]
    one = RetrievalService(fast_net, fast_style, fast_cfg, batch_size=PARALLEL_SERVE_BATCH, device=dev)
    want_serve = one.retrieve(holo)
    service = RetrievalService(fast_net, fast_style, fast_cfg, batch_size=PARALLEL_SERVE_BATCH,
                               mesh=mesh)
    asm_cuda.reset_launches()
    got_serve = service.retrieve(holo)
    torch.cuda.synchronize()
    serve_launches = dict(asm_cuda.LAUNCHES)
    if serve_launches["asm_const"] != mesh.shape["data"]:
        _die(f"the serving mesh launched {serve_launches}, want one asm_const a chunk", 1)
    info["serve_mesh"] = {
        "mesh": dict(mesh.shape), "batch": PARALLEL_SERVE_BATCH, "launches": serve_launches,
        "health": service.health(),
        "vs_one_device": compare_outputs(
            {k: torch.from_numpy(v) for k, v in got_serve.items()},
            {k: torch.from_numpy(v) for k, v in want_serve.items()},
            SLICE_AMP_TOL, SLICE_DIST_TOL, SLICE_PHASE_TOL, SLICE_PHASE_FRACTION,
            "the serving mesh and one device"),
    }
    ran = [p for p in gloo["partitions"].values() if "launches_by_rank" in p]
    info["launches"] = {
        "asm_const": serve_launches["asm_const"],
        "asm_dynamic": sum(r["launches"]["asm_dynamic"] for k, r in info["nccl_1_rank"].items()
                           if isinstance(r, dict))
        + sum(lr["asm_dynamic"] for p in ran for lr in p["launches_by_rank"]),
        "border_lines": sum(lr["border_lines"] for p in ran for lr in p["launches_by_rank"]),
    }
    # the refocus and the pipeline mirror the JAX package's "xla" choices:
    # torch.fft and matpad convs, no kernel (0 expected, counted all the same)
    rank_parts = [r[part] for r in ranks for part in ("sharded_refocus", "pipeline") if "skipped" not in r[part]]
    nccl = info["pipeline_nccl_1_rank"]
    counted = [v["launches"] for p in rank_parts for v in p.values() if isinstance(v, dict) and "launches" in v]
    counted += [nccl["retrieval"]["launches"]] + [c["launches"] for c in nccl["sharded_refocus"]["by_rank"][0].values()]
    info["pipeline_launches"] = {k: sum(c[k] for c in counted) for k in ("asm_const", "asm_dynamic", "border_lines")}
    return info



def run_cli(argv):
    """``cli.main(argv)`` in process on the card: (stdout lines, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = port_cli.main(argv)
    if rc != 0:
        _die(f"cli {' '.join(argv)} returned {rc}: {err.getvalue()[-2000:]}", 1)
    return out.getvalue().splitlines(), err.getvalue()


def trace_counts(path: str) -> dict:
    """Events of a Chrome trace: the asm_const regions on the host and on the
    card, and the device kernels (any, and the ASM tensor-core GEMMs)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    count = collections.Counter()
    for e in events:
        name, cat = e.get("name", ""), e.get("cat", "")
        if name == "asm_const":
            count[f"asm_const_{cat}"] += 1
        if cat == "kernel":
            count["kernels"] += 1
            count["asm_tc_gemm_kernels"] += "tc_gemm_kernel" in name
    return dict(count)


def drive_eval(records, smi):
    """The eval phase (see the module docstring); returns its readings."""
    reports = all(importlib.util.find_spec(m) is not None for m in ("PIL", "matplotlib"))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        prof = os.path.join(tmp, "profile")
        argv = ["eval", "--checkpoint", FAST, "--save-dir", tmp if reports else "",
                "--exp-name", "chip", "--json", "--profile", prof]
        asm_cuda.reset_launches()
        t0 = time.monotonic()
        lines, _ = run_cli(argv)
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        launches = dict(asm_cuda.LAUNCHES)
        trace = trace_counts(os.path.join(prof, "trace.json"))
        written = None
        if reports:
            out_dir = os.path.join(tmp, "chip")
            with open(os.path.join(out_dir, "metrics.jsonl")) as f:
                jsonl = f.read().splitlines()
            written = {"montages": len([n for n in os.listdir(out_dir) if n.endswith("_test.png")]),
                       "boxplot": os.path.isfile(os.path.join(out_dir, "distance_prediction.png")),
                       "metrics_jsonl_lines": len(jsonl)}
        asm_cuda.reset_launches()
        refine_lines, _ = run_cli(["eval", "--checkpoint", FAST, "--save-dir", "",
                                   "--refine", str(EVAL_REFINE_STEPS), "--json"])
        torch.cuda.synchronize()
        refine_launches = dict(asm_cuda.LAUNCHES)
    metrics, refined = json.loads(lines[-1]), json.loads(refine_lines[-1])
    rec = records["fp32"]
    diffs = {"mean_psnr_db": metrics["mean_psnr"] - rec["mean_psnr"],
             "heldout_mean_psnr_db": metrics["heldout_mean_psnr"] - rec["heldout_mean_psnr"],
             "r2": metrics["r2"] - rec["r2"]}
    n = 20
    want_refine = {"asm_const": n, "asm_dynamic": n * (EVAL_REFINE_STEPS + 1)}
    misses = [k for k, v in diffs.items() if abs(v) >= (EVAL_R2 if k == "r2" else EVAL_DB)]
    if launches != {"asm_const": n, "asm_dynamic": 0} or refine_launches != want_refine:
        misses.append("launches")
    want_trace = {"asm_const_user_annotation": n, "asm_const_gpu_user_annotation": n,
                  "asm_tc_gemm_kernels": ASM_TC_GEMMS * n}
    if {k: trace.get(k) for k in want_trace} != want_trace:
        misses.append("trace")
    if written is not None and written != {"montages": 100, "boxplot": True, "metrics_jsonl_lines": 1}:
        misses.append("reports")
    if not all(math.isfinite(v) for v in (refined["mean_psnr"], refined["r2"])):
        misses.append("refined metrics")
    info = {"nvidia_smi": smi, "printed": lines, "metrics_minus_record": diffs, "limits": [EVAL_DB, EVAL_R2],
            "launches": launches, "refine_launches": refine_launches, "want_refine_launches": want_refine,
            "trace": trace, "want_trace": want_trace, "reports": written if reports else
            "PIL or matplotlib absent on this machine: eval ran with --save-dir ''",
            "refined_printed": refine_lines, "seconds": seconds}
    if misses:
        emit({"eval_readings": info})
        _die(f"the eval phase missed {misses}", 1)
    return info


def _max_diff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def mat_eval_release(state, dev) -> dict:
    """``eval --checkpoint checkpoints/rbc_release --mat-root`` on the card
    at IMAGE^2, against the port's ``evaluate_mat_tree`` on the CPU for the
    same release and style vector: each batch's PSNR within
    GOLDEN_FP32_BATCH_DB, each distance within CARD_CPU_UM, no kernel
    launched (band-limited). The CLI must have loaded the release's sibling
    style vector."""
    argv = ["eval", "--checkpoint", RBC_RELEASE, "--mat-root", MAT_TREE, "--domain", "red_blood_cell",
            "--image-size", str(IMAGE), "--batch-size", "4", "--json"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mat_rbc_") as tmp:
        _reset_launch_counts()
        t0 = time.monotonic()
        lines, err = run_cli(argv + ["--save-dir", tmp, "--exp-name", "rbc"])
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        launches = _launch_counts()
        with open(os.path.join(tmp, "rbc", "mat_eval_metrics.json")) as f:
            card = json.load(f)
    style_path = os.path.join(REPO, "checkpoints", "rbc_style_vector.npz")
    cfg = DOMAIN_PRESETS["red_blood_cell"]()
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, image_size=IMAGE))
    net_cpu = StyleTransferNet.from_state_dict(state, cfg.model.width)
    cpu = evaluate_mat_tree(net_cpu, MAT_TREE, cfg, load_style_vector(style_path), domain="red_blood_cell",
                            batch_size=4, device="cpu")
    readings = {"psnr_db": _max_diff(card["psnr_per_batch"], cpu["psnr_per_batch"]),
                "distance_um": _max_diff(card["distance_pred_um"], cpu["distance_pred_um"])}
    loaded = [line for line in err.splitlines() if line.startswith("loaded ")]
    held = (readings["psnr_db"] < GOLDEN_FP32_BATCH_DB and readings["distance_um"] < CARD_CPU_UM
            and not any(launches.values()) and card["n_gt_scored"] == 9
            and f"loaded checkpoint {RBC_RELEASE}" in loaded and f"loaded style vector {style_path}" in loaded)
    info = {"argv": argv, "printed": lines, "loaded": loaded, "card_minus_cpu": readings,
            "limits": [GOLDEN_FP32_BATCH_DB, CARD_CPU_UM],
            "card": {k: card[k] for k in ("mean_psnr", "r2", "n_samples", "n_gt_scored")},
            "cpu": {k: cpu[k] for k in ("mean_psnr", "r2")}, "launches": launches, "seconds": seconds}
    if not held:
        emit({"mat_rbc_release_readings": info})
        _die("eval --mat-root on rbc_release: the card and the CPU disagree, or it loaded other files", 1)
    return info


def drive_mat(dev, rbc_state):
    """The mat phase (see the module docstring); returns its readings."""
    tree = ["--mat-root", MAT_TREE, "--domain", "red_blood_cell"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mat_") as tmp:
        run_dir, sv, sv_pt = os.path.join(tmp, "run"), os.path.join(tmp, "sv.npz"), os.path.join(tmp, "sv.pt")
        asm_cuda.reset_launches()
        t0 = time.monotonic()
        run_cli(["train", *tree, "--iterations", str(MAT_TRAIN_STEPS), "--batch-size", "2",
                 "--image-size", str(MAT_IMAGE), "--checkpoint-every", str(MAT_TRAIN_STEPS),
                 "--checkpoint-dir", run_dir, "--log-every", "1"])
        style_lines, _ = run_cli(["extract-style", *tree, "--checkpoint", run_dir, "--n-batches", "2",
                                  "--out", sv, "--pt-out", sv_pt])
        lines, _ = run_cli(["eval", *tree, "--image-size", str(MAT_IMAGE), "--checkpoint", run_dir,
                            "--style-vector", sv, "--batch-size", "4", "--save-dir", tmp,
                            "--exp-name", "mat", "--json"])
        stream_lines, _ = run_cli(["stream", "--root", MAT_TREE, "--domain", "red_blood_cell",
                                   "--checkpoint", run_dir, "--style-vector", sv, "--batch-size", "4"])
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        launches = dict(asm_cuda.LAUNCHES)
        with open(os.path.join(tmp, "mat", "mat_eval_metrics.json")) as f:
            card = json.load(f)
        with open(os.path.join(run_dir, "train_metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        card_style = load_style_vector(sv)
        pt_equal = all(np.array_equal(a, b) for a, b in zip(load_style_vector_pt(sv_pt), card_style))
        state = load_train_params(latest_snapshot(run_dir), ema=False)
    # The port on the CPU with the same weights.
    cfg = DOMAIN_PRESETS["red_blood_cell"]()
    net_cpu = StyleTransferNet.from_state_dict(state, cfg.model.width)
    sampler = MeasuredHologramSampler(MAT_TREE, cfg.data, cfg.physics, domain="red_blood_cell")
    ms, ss = zip(*(style_vector_from_holograms(net_cpu, p) for p in sampler.style_batches(2)))
    cpu_style = tuple(np.mean(np.concatenate(v), axis=0, keepdims=True) for v in (ms, ss))
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, image_size=MAT_IMAGE))
    cpu = evaluate_mat_tree(net_cpu, MAT_TREE, cfg, card_style, domain="red_blood_cell", batch_size=4,
                            device="cpu")
    stream = json.loads(stream_lines[-1])
    readings = {
        "psnr_db": _max_diff(card["psnr_per_batch"], cpu["psnr_per_batch"]),
        "distance_um": _max_diff(card["distance_pred_um"], cpu["distance_pred_um"]),
        "style_vector": max(_max_diff(a, b) / float(np.abs(b).max()) for a, b in zip(card_style, cpu_style)),
    }
    held = (readings["psnr_db"] < GOLDEN_FP32_BATCH_DB and readings["distance_um"] < CARD_CPU_UM
            and readings["style_vector"] < STYLE_TOL and card["n_gt_scored"] == 9
            and pt_equal and style_lines[-2] == f"torch-layout style vector written to {sv_pt}"
            and len(rows) == MAT_TRAIN_STEPS and "loss_supervised" not in rows[0]
            and all(math.isfinite(v) for r in rows for v in r.values()) and stream["frames"] == 9)
    info = {"card_minus_cpu": readings, "limits": [GOLDEN_FP32_BATCH_DB, CARD_CPU_UM, STYLE_TOL],
            "printed": lines, "extract_style_printed": style_lines, "pt_equals_npz_bit_for_bit": pt_equal,
            "card": {k: card[k] for k in ("mean_psnr", "r2", "n_samples", "n_gt_scored")},
            "cpu": {k: cpu[k] for k in ("mean_psnr", "r2")}, "train_last": rows[-1], "stream": stream,
            "launches": launches, "seconds": seconds}
    if not held:
        emit({"mat_readings": info})
        _die("the measured-tree chain on the card missed its checks", 1)
    info["rbc_release"] = mat_eval_release(rbc_state, dev)
    return info


def load_domain_release(tag: str):
    """``checkpoints/<tag>_release`` read by the port's own orbax reader, as
    ``drive_release`` reads the flagship (``bead``'s, saved on a TPU, with
    no target): (its state dict, the read's seconds and bytes)."""
    return read_release(os.path.join(REPO, "checkpoints", f"{tag}_release"))


def domain_protocol(tag: str):
    """The records' protocol of a domain: (its preset at DOMAIN_BATCH, its
    style vector, its eval bank, its records: fp32 and int8)."""
    preset, make_bank, _ = DOMAINS[tag]
    cfg = DOMAIN_PRESETS[preset]()
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, batch_size=DOMAIN_BATCH))
    style = load_style_vector(os.path.join(REPO, "checkpoints", f"{tag}_style_vector.npz"))
    records = {}
    for kind, name in (("fp32", f"{tag}_domain_metrics.json"), ("int8", f"{tag}_quant_domain_metrics.json")):
        with open(os.path.join(REPO, "checkpoints", name)) as f:
            records[kind] = json.load(f)
    return cfg, style, make_bank(n=512, seed=DOMAIN_BANK_SEED), records


def domain_stream_batch(cfg, bank, device, i: int = 0):
    """Batch ``i`` of the records' stream: (intensity holograms, GT phase)."""
    batch = synth.synth_batch_from_key(jax_random.fold_in(jax_random.key(DOMAIN_STREAM_SEED), i),
                                       torch.as_tensor(bank, device=device), cfg.data, cfg.physics,
                                       return_gt=True)
    return batch["content_holo"] ** 2, batch["phase_content"]


_KERNEL_COUNTS = (asm_cuda, conv_stack, reflect_border, halo_conv)


def _launch_counts() -> dict:
    """Every kernel's launches since ``_reset_launch_counts``."""
    return {k: v for m in _KERNEL_COUNTS for k, v in m.LAUNCHES.items()}


def _reset_launch_counts() -> None:
    for m in _KERNEL_COUNTS:
        m.reset_launches()


def domain_ring_batch(net, cfg, style, bank, dev) -> dict:
    """The stream's first batch through ``retrieval_step`` in fp32 with the
    ``cuda`` ring (exactly REFLECT_CONVS launches) against ``matpad``, by the
    slice phase's rules."""
    holo, _ = domain_stream_batch(cfg, bank, dev)
    sm, ss = (torch.as_tensor(np.asarray(v), dtype=torch.float32, device=dev) for v in style)
    d_style = float(cfg.physics.to_network_units(float(cfg.data.style_distances[0])))
    fn = make_retrieval_fn(cfg.physics, alpha=cfg.eval.alpha, device=dev)
    try:
        set_reflect_backend("cuda")
        _reset_launch_counts()
        out_cuda = fn(net, holo, sm, ss, d_style)
        torch.cuda.synchronize()
        launches = _launch_counts()
        set_reflect_backend("matpad")
        out_matpad = fn(net, holo, sm, ss, d_style)
        torch.cuda.synchronize()
    finally:
        set_reflect_backend("auto")
    want = {k: 0 for k in launches} | {"border_lines": REFLECT_CONVS}
    if launches != want:
        _die(f"the domain batch with the cuda ring launched {launches}, want {want}", 1)
    return {"launches": launches,
            "cuda_vs_matpad": compare_outputs(out_cuda, out_matpad, SLICE_AMP_TOL, SLICE_DIST_TOL,
                                              SLICE_PHASE_TOL, SLICE_PHASE_FRACTION,
                                              "the domain batch's cuda and matpad rings")}


def held_mean(metrics, want_db, want_r2, db_tol) -> dict:
    """Mean PSNR within ``db_tol`` and R² within SUITE_R2 of a reading."""
    d_db, d_r2 = metrics["mean_psnr"] - want_db, metrics["r2"] - want_r2
    return {"mean_psnr": metrics["mean_psnr"], "want_mean_psnr": want_db, "mean_psnr_diff_db": d_db,
            "margin_db": db_tol - abs(d_db), "r2": metrics["r2"], "want_r2": want_r2, "r2_diff": d_r2,
            "limits": [db_tol, SUITE_R2], "held": abs(d_db) < db_tol and abs(d_r2) < SUITE_R2}


def run_domain_release(tag, state, dev) -> dict:
    """Every path of a domain release on its stream, each against its record
    (see DOMAINS): fp32, refined, refine-distance, int8 with the stacks off
    and on, and one batch with the ``cuda`` ring. Each path's launches are
    counted from 0 just before it and read just after."""
    _, _, refine_steps = DOMAINS[tag]
    cfg, style, bank, records = domain_protocol(tag)
    rec, q_rec = records["fp32"], records["int8"]
    net = StyleTransferNet.from_state_dict(state, cfg.model.width).to(dev)
    scales = quant.load_scales(os.path.join(REPO, "checkpoints", f"{tag}_quant_scales.json"))
    n, n_q, bf16 = len(rec["psnr_per_batch"]), q_rec["n_batches"], torch.bfloat16
    if (rec["refined_steps"], rec["refine_distance_steps"]) != (refine_steps, DOMAIN_REFINE_DISTANCE_STEPS):
        _die(f"{tag}'s records were refined for {rec['refined_steps']} and {rec['refine_distance_steps']} "
             f"steps, the phase runs {refine_steps} and {DOMAIN_REFINE_DISTANCE_STEPS}", 1)
    paths = {
        "fp32": ("off", n, {}),
        "refined": ("off", n, {"refine_steps": refine_steps}),
        "refine_distance": ("off", DOMAIN_REFINE_DISTANCE_BATCHES,
                            {"refine_steps": DOMAIN_REFINE_DISTANCE_STEPS, "refine_distance": True}),
        "int8_stacks_off": ("off", n_q, {"quant_scales": scales, "dtype": bf16}),
        "int8_stacks_on": ("on", n_q, {"quant_scales": scales, "dtype": bf16}),
    }
    runs, launches, tc, seconds = {}, {}, {}, {}
    try:
        for path, (stacks, nb, kw) in paths.items():
            quant.set_fused_stacks(stacks)
            _reset_launch_counts()
            t0 = time.monotonic()
            runs[path] = evaluate_synth_domain(net, cfg, bank, style, n_batches=nb,
                                               seed=DOMAIN_STREAM_SEED, device=dev, **kw)
            torch.cuda.synchronize()
            seconds[path] = time.monotonic() - t0
            launches[path] = _launch_counts()
            tc[path] = dict(conv_stack.TC_LAUNCHES)
    finally:
        quant.set_fused_stacks("auto")
    with open(DOMAIN_CPU_READINGS) as f:
        cpu = json.load(f)[tag]
    fp, cpu_fp, cpu_rd = runs["fp32"], cpu["fp32"], cpu["refine_distance"]
    batch_db = _max_diff(fp["psnr_per_batch"], cpu_fp["psnr_per_batch"])
    um = _max_diff(fp["distance_pred_um"], cpu_fp["distance_pred_um"])
    true_um = _max_diff(fp["distance_true_um"], rec["distance_true_um"])
    on, off = runs["int8_stacks_on"], runs["int8_stacks_off"]
    fp32 = held_mean(fp, rec["mean_psnr"], rec["r2"], GOLDEN_FP32_BATCH_DB)
    fp32.update({
        "max_batch_psnr_diff_db_vs_cpu": batch_db, "batch_db_margin": GOLDEN_FP32_BATCH_DB - batch_db,
        "max_distance_diff_um_vs_cpu": um, "max_true_distance_diff_um": true_um,
        "batch_limits": [GOLDEN_FP32_BATCH_DB, GOLDEN_UM],
        "record_max_batch_psnr_diff_db": _max_diff(fp["psnr_per_batch"], rec["psnr_per_batch"]),
        "record_max_distance_diff_um": _max_diff(fp["distance_pred_um"], rec["distance_pred_um"]),
        "cpu_command": cpu_fp["command"],
    })
    fp32["held"] = (fp32["held"] and batch_db < GOLDEN_FP32_BATCH_DB and um < GOLDEN_UM
                    and true_um < 1e-3 and cpu_fp["batches"] == n)
    readings = {
        "fp32": fp32,
        "refined": {"steps": refine_steps, **held_mean(runs["refined"], rec["refined_mean_psnr"],
                                                       rec["refined_r2"], REFINE_DB_TOL)},
        "refine_distance": {"steps": DOMAIN_REFINE_DISTANCE_STEPS, "batches": DOMAIN_REFINE_DISTANCE_BATCHES,
                            **held_mean(runs["refine_distance"], cpu_rd["mean_psnr"], cpu_rd["r2"], REFINE_DB_TOL),
                            "record_mean_psnr_10_batches": rec["refine_distance_mean_psnr"],
                            "record_r2_10_batches": rec["refine_distance_r2"], "cpu_command": cpu_rd["command"]},
        "int8_stacks_off": {"batches": n_q, **held_mean(off, cpu["int8"]["mean_psnr"], cpu["int8"]["r2"],
                                                        SUITE_DB),
                            "record_mean_psnr": q_rec["mean_psnr"], "record_r2": q_rec["r2"],
                            "cpu_command": cpu["int8"]["command"]},
        "int8_stacks_on": {"mean_psnr": on["mean_psnr"], "r2": on["r2"],
                           "minus_stacks_off_db": on["mean_psnr"] - off["mean_psnr"],
                           "tensor_core_launches": tc["int8_stacks_on"]},
    }
    readings["int8_stacks_off"]["held"] &= cpu["int8"]["batches"] == n_q
    readings["refine_distance"]["held"] &= cpu_rd["batches"] == DOMAIN_REFINE_DISTANCE_BATCHES
    stacks = {"fused_encoder_head": n_q, "fused_conv_tail": n_q}
    want = {p: {k: stacks.get(k, 0) if p == "int8_stacks_on" else 0 for k in launches[p]} for p in paths}
    misses = [p for p, r in readings.items() if not r.get("held", True)]
    if launches != want or tc["int8_stacks_on"] != stacks:
        misses.append("launches")
    info = {"readings": readings, "launches": launches, "seconds_by_path": seconds}
    if misses:
        emit({"domain_readings": {tag: info}, "want_launches": want})
        _die(f"the {tag} release on the card missed {misses}", 1)
    info["ring_batch"] = domain_ring_batch(net, cfg, style, bank, dev)
    return info


def drive_domain(releases, dev, smi):
    """The domain phase (see the module docstring); returns its readings."""
    rows = {tag: {"read": releases[tag][1], **run_domain_release(tag, releases[tag][0], dev)}
            for tag in DOMAINS}
    # The band-limited refocus of a retrieval at this batch (rbc's style
    # plane, -6 mm): torch.fft, as neither kernel takes a band limit; beside
    # the same refocus without it through torch.fft and through asm_const.
    physics = DOMAIN_PRESETS["red_blood_cell"]().physics
    kw = dict(wavelength=physics.wavelength, pixel_size=physics.pixel_size)
    d_m = -float(physics.to_metres(physics.to_network_units(6.0)))
    xre, xim = random_planes(DOMAIN_BATCH, seed=2, device=dev)
    field = torch.complex(xre, xim)
    timing = {
        "B": DOMAIN_BATCH, "distance_m": d_m,
        "band_limited_torch_fft_ms": median_ms(lambda: propagate(field, d_m, band_limit=True, **kw)),
        "torch_fft_ms": median_ms(lambda: propagate_torch(field, d_m, **kw)),
        "asm_const_ms": median_ms(lambda: asm_cuda.asm_const(xre, xim, d_m, **kw)),
    }
    launches = collections.Counter()
    for row in rows.values():
        for counts in (*row["launches"].values(), row["ring_batch"]["launches"]):
            launches.update(counts)
    return {"nvidia_smi": smi, "releases": rows, "launches": dict(launches), "band_limited_refocus": timing}


def start_cold(script: str, *args: str):
    """Start ``script`` in a fresh Python process on the card: (the
    process, when it was started)."""
    t0 = time.time()
    child = subprocess.Popen([sys.executable, "-c", script, REPO, *args],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    _CHILDREN.append(child)
    return child, t0


def finish_cold(child, t0: float) -> dict:
    """The reading of a ``start_cold`` process, with the seconds from its
    start to its first answer and to each step before it."""
    try:
        out, err = child.communicate(timeout=COLD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        child.kill()
        _die(f"a cold start took over {COLD_TIMEOUT_S} s", 3)
    _CHILDREN.remove(child)
    if child.returncode != 0:
        _die(f"a cold start failed: {err[-2000:]}", 1)
    reading = json.loads(out.strip().splitlines()[-1])
    for step in ("imported", "loaded", "answered"):
        reading[f"seconds_to_{step}"] = reading.pop(f"{step}_at") - t0
    return reading


class Exports:
    """The export phase's exports (EXPORTER) in a process of its own,
    started once every kernel is built, and its two cold starts, started as
    soon as the exports are written: all of it runs beside the phases
    before the export phase. ``result`` waits for the exports and returns
    (their reading by path, the cold starts' processes by name)."""

    def __init__(self, holo: np.ndarray):
        self.tmp = tempfile.mkdtemp(prefix="chip_smoke_export_")
        self.holo_path = os.path.join(self.tmp, "holo.npy")
        np.save(self.holo_path, holo)
        self.child, _ = start_cold(EXPORTER, FAST, str(EXPORT_BATCH), self.tmp)
        self.reading, self.cold, self.error = None, {}, None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            out, err = self.child.communicate(timeout=EXPORT_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            self.child.kill()
            self.error = f"the exports took over {EXPORT_TIMEOUT_S} s"
            return
        if self.child.returncode != 0:
            self.error = f"the exports failed: {err[-2000:]}"
            return
        self.reading = json.loads(out.strip().splitlines()[-1])
        self.cold = {"retrieval_service": start_cold(COLD_LIVE, FAST, self.holo_path),
                     "artifact": start_cold(COLD_ARTIFACT, self.reading["fp32"]["path"], self.holo_path)}

    def result(self):
        self.thread.join()
        if self.error is not None:
            _die(self.error, 1)
        return self.reading, self.cold

    def close(self):
        shutil.rmtree(self.tmp, ignore_errors=True)


def artifact_vs(got: dict, want: dict) -> dict:
    """max|got - want| / max|want| by key; fails the run past ARTIFACT_TOL."""
    diffs = {k: float(np.abs(got[k] - want[k]).max() / max(float(np.abs(want[k]).max()), 1e-30))
             for k in want}
    if set(got) != set(want) or not all(v <= ARTIFACT_TOL for v in diffs.values()):
        _die(f"the artifact and the live path disagree: {diffs}", 1)
    return {"rel_err": diffs, "bit_equal": not any(diffs.values())}


def drive_export(exports, fast_net, fast_cfg, fast_style, fast_scales, records, goldens, dev, smi):
    """The export phase (see the module docstring) on ``exports``
    (``Exports``, of golden batch 10); returns its readings."""
    physics = fast_cfg.physics
    d_style = float(physics.to_network_units(fast_cfg.data.style_distances[0]))
    holo = goldens.content_holo[10]
    all_holo = goldens.content_holo.reshape(-1, 1, IMAGE, IMAGE)
    t0, stages = time.monotonic(), {}

    def mark(stage):
        # where the phase's time went, on stderr as it goes (an overrun shows it)
        stages[stage] = time.monotonic() - t0
        print(json.dumps({"export_stage": stage, "seconds": stages[stage]}), file=sys.stderr, flush=True)

    try:
        # The cold starts may still run: the timings wait for them.
        exported, children = exports.result()
        mark("exports_waited")
        path, qpath = exported["fp32"]["path"], exported["int8"]["path"]
        file_bytes = os.path.getsize(path)
        art = load_artifact(path, dev)
        graph_ops = library.graph_ops(art._module.graph)
        live = RetrievalService(fast_net, fast_style, fast_cfg, batch_size=EXPORT_BATCH, device=dev)
        vs_live = artifact_vs(art.retrieve(holo), live.retrieve(holo))
        mark("vs_live")

        # The suite through the frozen file, one asm_const a batch.
        asm_cuda.reset_launches()
        suite = evaluate_golden_suite(
            None, goldens, fast_cfg, style_override=fast_style, device=dev,
            retrieval_fn=lambda net, h, sm, ss, d: art.retrieve(h.cpu().numpy()))
        torch.cuda.synchronize()
        launches = dict(asm_cuda.LAUNCHES)
        rec = records["fp32"]
        batch_db = max(abs(a - b) for a, b in zip(suite["psnr_per_batch"], rec["psnr_per_batch"]))
        um = max(abs(a - b) for a, b in zip(suite["distance_pred_um"], rec["distance_pred_um"]))
        mark("suite")

        # int8 with the stacks on: the head and tail ops in the graph.
        quant.set_fused_stacks("on")
        try:
            qart = load_artifact(qpath, dev)
            conv_stack.reset_launches()
            q_got = qart.retrieve(holo)
            torch.cuda.synchronize()
            q_launches = dict(conv_stack.LAUNCHES)
            q_want = direct_answer(make_retrieval_fn(physics, quant_scales=fast_scales, device=dev),
                                   fast_net, holo, fast_style, d_style, EXPORT_BATCH, dev)
        finally:
            quant.set_fused_stacks("auto")
        q_ops = library.graph_ops(qart._module.graph)
        int8_vs_live = artifact_vs(q_got, q_want)
        mark("int8")

        service = ArtifactService(path, dev)
        service.warmup()
        with serving(service) as url:
            answer = retrieve_remote(url, holo)
            with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
                health = json.loads(r.read())
        check_equal(answer, service.retrieve(holo), "the artifact served over HTTP")
        mark("http")
        cold = {k: finish_cold(*v) for k, v in children.items()}
        mark("cold_starts")

        x = torch.from_numpy(all_holo[:EXPORT_BATCH]).to(dev)
        fn = make_retrieval_fn(physics, device=dev)
        style_dev = tuple(torch.as_tensor(v, device=dev) for v in fast_style)
        ms = {"artifact": median_ms(lambda: art(x), reps=EXPORT_TIMED, warmup=2),
              "live": median_ms(lambda: fn(fast_net, x, *style_dev, d_style), reps=EXPORT_TIMED, warmup=2)}
        mark("timed")
    finally:
        exports.close()
    want_ops = ["holostyle.asm_const.default"]
    misses = []
    if graph_ops != want_ops or art.meta["ops"] != want_ops or exported["fp32"]["ops"] != want_ops:
        misses.append("the fp32 graph's ops")
    if sorted(set(q_ops)) != sorted(["holostyle.asm_const.default", "holostyle.fused_conv_tail.default",
                                     "holostyle.fused_encoder_head.default"]):
        misses.append("the int8 graph's ops")
    if launches != {"asm_const": goldens.n_batches, "asm_dynamic": 0}:
        misses.append("the suite's launches")
    if not (batch_db < GOLDEN_BATCH_DB and batch_db < GOLDEN_FP32_BATCH_DB and um < GOLDEN_UM):
        misses.append("the suite against its record")
    if q_launches != {"fused_encoder_head": 1, "fused_conv_tail": 1}:
        misses.append("the int8 stacks' launches")
    if cold["artifact"]["model_code"] or cold["artifact"]["jax"]:
        misses.append("the artifact's process imported model code or JAX")
    want_health = {"status", "device", "artifact", "platforms", "batch_size", "image_size", "width",
                   "quantized", "refine_steps", "n_served"}
    if set(health) != want_health or health["artifact"] != path or health["platforms"] != ["cuda"]:
        misses.append("/healthz")
    info = {"nvidia_smi": smi, "batch": EXPORT_BATCH,
            "export_seconds": {k: v["seconds"] for k, v in exported.items()},
            "stage_seconds": stages, "file_bytes": file_bytes,
            "graph_ops": graph_ops, "int8_graph_ops": sorted(set(q_ops)), "cold_start": cold,
            "vs_live_service": vs_live, "int8_vs_live": int8_vs_live, "tol": ARTIFACT_TOL,
            "suite": {"mean_psnr": suite["mean_psnr"], "record_mean_psnr": rec["mean_psnr"],
                      "r2": suite["r2"], "max_batch_psnr_diff_db": batch_db,
                      "max_distance_diff_um": um,
                      "limits": [GOLDEN_BATCH_DB, GOLDEN_FP32_BATCH_DB, GOLDEN_UM]},
            "launches": launches, "int8_launches": q_launches, "health": health, "call_ms": ms,
            "holograms_per_s": {k: EXPORT_BATCH / v * 1e3 for k, v in ms.items()}}
    if misses:
        emit({"export_readings": info})
        _die(f"the export phase missed {misses}", 1)
    return info


def _sweep(net, style, goldens, device):
    """What ``cli sweep`` computes (seed 0), on ``device``: the batch and
    the retrieval."""
    physics = PhysicsConfig()
    bank = torch.from_numpy(synth.golden_digit_bank(goldens)).to(device)
    batch = synth.synth_interpolation_batch(
        jax_random.key(0), bank, data=DataConfig(style_distances=SWEEP_DISTANCES), physics=physics)
    out = retrieval_step(net, batch["content_holo"] ** 2, style[0], style[1],
                         batch["distance_style"], physics, device=device)
    return {k: v.float().cpu() for k, v in {**batch, **out}.items()}


def drive_commands(fast_net, fast_cfg, fast_style, goldens, dev, card_name, smi):
    """The commands phase (see the module docstring); returns its readings."""
    from PIL import Image

    from style_transfer_based_holographic_imaging_tpu_torch.eval.report import to_image

    misses = []
    asm_cuda.reset_launches()
    lines, _ = run_cli(["synth-bench", "--batch-size", str(SYNTH_BENCH_BATCH)])
    torch.cuda.synchronize()
    bench = {"line": json.loads(lines[-1]), "launches": dict(asm_cuda.LAUNCHES)}
    if bench["launches"] != {"asm_const": 0, "asm_dynamic": SYNTH_BENCH_REPS + 1}:
        misses.append("synth-bench's launches")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_sweep_") as tmp:
        asm_cuda.reset_launches()
        sweep_lines, _ = run_cli(["sweep", "--checkpoint", FAST, "--save-dir", tmp])
        torch.cuda.synchronize()
        sweep_launches = dict(asm_cuda.LAUNCHES)
        montage = np.asarray(Image.open(os.path.join(tmp, "interpolation_sweep.png")))
    net_cpu = copy.deepcopy(fast_net).cpu()
    card, cpu = _sweep(fast_net, fast_style, goldens, dev), _sweep(net_cpu, fast_style, goldens, "cpu")
    planes = ("content_holo", "amp_field", "amp_foc", "ph_foc")
    grid = to_image(np.concatenate([np.concatenate([cpu[k][i, 0].numpy() for k in planes], axis=1)
                                    for i in range(len(SWEEP_DISTANCES))], axis=0))
    grey = np.abs(montage.astype(np.int32) - grid.astype(np.int32))

    def plane_psnr(out):
        return [float(psnr(zero_mean(out["ph_foc"][i]), zero_mean(out["phase_content"][i])))
                for i in range(len(SWEEP_DISTANCES))]

    sweep = {
        "printed": sweep_lines, "launches": sweep_launches,
        "holo_rel_err": max(rel_err(card[k], cpu[k]) for k in ("style_holo", "content_holo")),
        "psnr_db": _max_diff(plane_psnr(card), plane_psnr(cpu)),
        "card_psnr": plane_psnr(card),
        "distance_um": 1e3 * PhysicsConfig().distance_normalize
        * _max_diff(card["distance_pred"], cpu["distance_pred"]),
        "montage_grey_max": int(grey.max()), "montage_grey_share_over_1": float((grey > 1).mean()),
        "limits": [SYNTH_TOL, GOLDEN_FP32_BATCH_DB, GOLDEN_UM, GREY_SHARE],
    }
    if not (sweep_launches == SWEEP_LAUNCHES and sweep["holo_rel_err"] < SYNTH_TOL
            and sweep["psnr_db"] < GOLDEN_FP32_BATCH_DB and sweep["distance_um"] < GOLDEN_UM
            and sweep["montage_grey_share_over_1"] <= GREY_SHARE and montage.shape == grid.shape):
        misses.append("sweep")

    doctor_lines, _ = run_cli(["doctor"])
    doctor = json.loads("\n".join(doctor_lines))
    # The card's copy holds the flagship's orbax release (checkpoints/
    # release), which the port reads; every release listed has weights the
    # port loads.
    releases = doctor["releases"]
    if (card_name not in doctor["devices"] or releases.get("flagship", {}).get("weights") != "orbax"
            or not all(r.get("weights") for r in releases.values())
            or not str(doctor.get("transport_ready")).startswith("not applicable")):
        misses.append("doctor")

    content, style = np.sqrt(goldens.content_holo[10]), np.sqrt(goldens.content_holo[0])
    s_card = stylize(fast_net, content, style)
    s_cpu = stylize(net_cpu, content, style)
    styl = {k: rel_err(s_card[k].cpu(), s_cpu[k]) for k in s_cpu}
    if not all(v < SLICE_AMP_TOL for v in styl.values()):
        misses.append("stylize")
    info = {"nvidia_smi": smi, "synth_bench": bench, "sweep": sweep,
            "doctor_devices": doctor["devices"], "doctor_releases": sorted(doctor["releases"]),
            "doctor_transport_ready": doctor.get("transport_ready"),
            "stylize_rel_err": styl, "stylize_tol": SLICE_AMP_TOL}
    if misses:
        emit({"commands_readings": info})
        _die(f"the commands phase missed {misses}", 1)
    return info


def compare_ablation(got, ref, label):
    """Two (amp, phase, dist) outputs of an ablation net by the slice phase's
    rules: amp relative to max|ref|, the distance absolute, the phase (the
    decoder's channel, not wrapped) within SLICE_PHASE_TOL in
    SLICE_PHASE_FRACTION of the pixels."""
    amp, phase, dist = (t.cpu() for t in got)
    amp_ref, phase_ref, dist_ref = (t.cpu() for t in ref)
    result = {"amp_rel_err": rel_err(amp, amp_ref), "amp_tol": SLICE_AMP_TOL,
              "distance_abs_err": float((dist - dist_ref).abs().max()), "distance_tol": SLICE_DIST_TOL,
              "phase_frac_within_tol": float(((phase - phase_ref).abs() < SLICE_PHASE_TOL).float().mean()),
              "phase_max_abs_err": float((phase - phase_ref).abs().max()), "phase_tol": SLICE_PHASE_TOL,
              "phase_fraction": SLICE_PHASE_FRACTION}
    if not (result["amp_rel_err"] < SLICE_AMP_TOL and result["distance_abs_err"] < SLICE_DIST_TOL
            and result["phase_frac_within_tol"] >= SLICE_PHASE_FRACTION):
        _die(f"{label} disagree: {json.dumps(result)}", 1)
    return result


def trivial_net_card_vs_cpu(goldens, dev):
    """(a): TrivialSolutionNet on the golden batch tiled to ABLATION_BATCH:
    the ring's launches of the cuda forward, cuda against matpad, and the
    batch of 5 on the card against the CPU. Returns the readings and the
    card's matpad outputs."""
    net = seeded_weights_(TrivialSolutionNet(), seed=0).to(dev).eval()
    holo = goldens.content_holo[ABLATION_GOLDEN]
    content = torch.as_tensor(np.sqrt(np.resize(holo, (ABLATION_BATCH,) + holo.shape[1:])), device=dev)
    with torch.inference_mode():
        try:
            set_reflect_backend("cuda")
            reflect_border.reset_launches()
            with recording_ring_layers() as ring_layers:
                out_cuda = net(content)
            torch.cuda.synchronize()
            launches = reflect_border.LAUNCHES["border_lines"]
            set_reflect_backend("matpad")
            out_matpad = net(content)
            torch.cuda.synchronize()
        finally:
            set_reflect_backend("auto")
        if launches != REFLECT_CONVS:
            _die(f"TrivialSolutionNet launched the ring {launches} times a forward, want {REFLECT_CONVS}", 1)
        b = holo.shape[0]
        out_cpu = copy.deepcopy(net).cpu()(content[:b].cpu())
    shapes = [tuple(t.shape) for t in out_cuda]
    if shapes != [(ABLATION_BATCH, 1, IMAGE, IMAGE)] * 2 + [(ABLATION_BATCH, 1)] or not all(
            bool(torch.isfinite(t).all()) for t in out_cuda):
        _die(f"TrivialSolutionNet outputs: shapes {shapes} or non-finite", 1)
    info = {"B": ABLATION_BATCH, "golden_batch": ABLATION_GOLDEN, "ring_launches": launches,
            "ring_layers": ring_layers,
            "cuda_vs_matpad": compare_ablation(out_cuda, out_matpad, "TrivialSolutionNet's cuda and matpad rings"),
            "card_vs_cpu": compare_ablation([t[:b] for t in out_matpad], out_cpu,
                                            "TrivialSolutionNet on the card and the CPU"),
            "distance_range": [float(out_matpad[2].min()), float(out_matpad[2].max())]}
    return info, out_matpad


def seeded_autoencoder(seed: int, **kw) -> torch.nn.Module:
    """HoloAutoEncoder(**kw) with its lazy convs shaped by one 16^2 call on
    the CPU, every conv from ``torch.Generator`` seed ``seed``."""
    net = HoloAutoEncoder(**kw)
    with torch.no_grad():
        net(torch.zeros(1, 1, 16, 16))
    return seeded_weights_(net, seed)


def autoencoder_card_vs_cpu(dev):
    """(b): HoloAutoEncoder at its full widths on the card: instance norm with
    skips at ABLATION_AE_BATCH and at B = 1 against the CPU; group norm,
    batch norm in train mode (its running averages move) and no skips, one
    call each."""
    g = torch.Generator().manual_seed(2)
    x = torch.rand(ABLATION_AE_BATCH, 1, IMAGE, IMAGE, generator=g)
    info = {}
    for name, kw, train in (("instance", {}, False), ("group", {"norm": "group"}, False),
                            ("batch_train", {"norm": "batch"}, True), ("no_skip", {"skip": False}, False)):
        net = seeded_autoencoder(3, **kw).to(dev)
        before = {k: v.clone() for k, v in net.state_dict().items() if "running" in k}
        with torch.no_grad():
            y = net(x.to(dev), train=train)
        torch.cuda.synchronize()
        row = {"shape": list(y.shape), "finite": bool(torch.isfinite(y).all()), "max_abs": float(y.abs().max())}
        if before:
            moved = [float((net.state_dict()[k] - v).abs().max()) for k, v in before.items()]
            row["running_stats_moved"] = min(moved) > 0 and all(math.isfinite(m) for m in moved)
        if name == "instance":
            with torch.no_grad():
                one = net(x[:1].to(dev)).cpu()
                ref = copy.deepcopy(net).cpu()(x[:1])
            row["card_vs_cpu_b1_rel_err"], row["tol"] = rel_err(one, ref), ABLATION_AE_TOL
        info[name] = row
        if (row["shape"] != [ABLATION_AE_BATCH, 2, IMAGE, IMAGE] or not row["finite"]
                or not row.get("running_stats_moved", True)
                or not row.get("card_vs_cpu_b1_rel_err", 0.0) < ABLATION_AE_TOL):
            _die(f"HoloAutoEncoder ({name}) on the card missed its checks: {json.dumps(row)}", 1)
    return info


def check_unwraps(amp, phase, physics, dev):
    """(c): the refocused phase of (a)'s outputs (-0.2 mm, as retrieval_step
    refocuses), unwrapped on the card by the matmul DCT in highest and high
    and by the fft DCT, against each other and against the CPU; the native
    unwrap on the host beside them."""
    with torch.inference_mode():
        _, wrapped = holo_forward(amp, phase, -0.2, physics, return_field=True)
    runs = {}
    try:
        for name, backend, precision, device in (("matmul_highest", "matmul", "highest", dev),
                                                 ("matmul_high", "matmul", "high", dev),
                                                 ("fft", "fft", "highest", dev),
                                                 ("cpu_matmul_highest", "matmul", "highest", "cpu")):
            set_dct_backend(backend)
            set_dct_precision(precision)
            w = wrapped.to(device)
            runs[name] = (unwrap_phase(w, congruent=False).cpu(), unwrap_phase(w).cpu())
        torch.cuda.synchronize()
    finally:
        set_dct_backend("auto")
        set_dct_precision("highest")
    w = wrapped.cpu()
    ref_raw, ref = runs["matmul_highest"]
    info = {"shape": list(w.shape), "raw_tol": UNWRAP_TOL, "snapped_fraction": SLICE_PHASE_FRACTION}
    held = True
    for name, (raw, snapped) in runs.items():
        k = (snapped - w) / (2 * math.pi)
        row = {"congruence_max_err": float((k - torch.round(k)).abs().max())}
        if name != "matmul_highest":
            row["raw_rel_err_vs_matmul_highest"] = rel_err(raw, ref_raw)
            row["snapped_equal_fraction"] = float((snapped == ref).float().mean())
            held &= row["snapped_equal_fraction"] >= SLICE_PHASE_FRACTION
            held &= name == "matmul_high" or row["raw_rel_err_vs_matmul_highest"] < UNWRAP_TOL
        held &= row["congruence_max_err"] < 1e-3
        info[name] = row
    t0 = time.monotonic()
    native = torch.from_numpy(unwrap_phase_native(w))
    k = (native - w) / (2 * math.pi)
    d = zero_mean(native) - zero_mean(ref)
    info["native_host"] = {"seconds": time.monotonic() - t0,
                           "congruence_max_err": float((k - torch.round(k)).abs().max()),
                           "vs_dct_max_abs_rad": float(d.abs().max()),
                           "vs_dct_frac_within_0.05_rad": float((d.abs() < 0.05).float().mean())}
    if not held:
        _die(f"the unwraps on the card missed their checks: {json.dumps(info)}", 1)
    return info


def write_reference_files(root: str, seed: int) -> dict:
    """The reference's checkpoint files (``nn.Sequential`` keys, the VGG's
    stem RGB) at full width from ``torch.Generator`` seed ``seed``: He-normal
    kernels, N(0, 0.01^2) biases."""
    g = torch.Generator().manual_seed(seed)

    def convs(layers, transposed=()):
        state = {}
        for idx, c_out, c_in, k in layers:
            shape = (c_in, c_out, k, k) if idx in transposed else (c_out, c_in, k, k)
            fan_in = c_in if idx in transposed else c_in * k * k
            state[f"{idx}.weight"] = torch.randn(shape, generator=g) * (2.0 / fan_in) ** 0.5
            state[f"{idx}.bias"] = 0.01 * torch.randn(c_out, generator=g)
        return state

    dist = {}
    for name, (n_out, n_in) in REFERENCE_DISTANCE.items():
        dist[f"{name}.weight"] = torch.randn(n_out, n_in, generator=g) * (2.0 / n_in) ** 0.5
        dist[f"{name}.bias"] = 0.01 * torch.randn(n_out, generator=g)
    paths = {}
    for name, state in (("vgg", convs(REFERENCE_VGG)), ("decoder", convs(REFERENCE_DECODER, REFERENCE_TRANSPOSED)),
                        ("distance", dist)):
        paths[name] = os.path.join(root, f"{name}.pth")
        torch.save(state, paths[name])
    return paths


def reference_card_vs_cpu(goldens, physics, dev):
    """(d): the reference's files through ``load_reference_checkpoint`` and
    ``retrieval_step`` on one golden batch, on the card against the same
    files on the CPU."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_reference_") as tmp:
        paths = write_reference_files(tmp, REFERENCE_SEED)
        files = (paths["vgg"], paths["decoder"], paths["distance"])
        net, net_cpu = (load_reference_checkpoint(*files, device=d) for d in (dev, "cpu"))
    if tuple(net.encoder.stem.weight.shape) != (3, 1, 1, 1):
        _die(f"the reference's RGB stem was not collapsed: {tuple(net.encoder.stem.weight.shape)}", 1)
    args = (goldens.content_holo[ABLATION_GOLDEN], goldens.style_mean, goldens.style_std,
            float(goldens.distance_style[ABLATION_GOLDEN].reshape(-1)[0]), physics)
    card = retrieval_step(net, *args, device=dev)
    cpu = retrieval_step(net_cpu, *args, device="cpu")
    return compare_outputs(card, cpu, SLICE_AMP_TOL, SLICE_DIST_TOL, SLICE_PHASE_TOL, SLICE_PHASE_FRACTION,
                           "the reference checkpoint on the card and the CPU")


def drive_ablations(goldens, physics, dev, smi):
    """The ablations phase (see the module docstring); returns its readings."""
    part_seconds = {}

    def part(name, fn, *args):
        t0 = time.monotonic()
        out = fn(*args)
        part_seconds[name] = time.monotonic() - t0
        return out

    trivial, (amp, phase, _) = part("a", trivial_net_card_vs_cpu, goldens, dev)
    autoencoder = part("b", autoencoder_card_vs_cpu, dev)
    unwraps = part("c", check_unwraps, amp, phase, physics, dev)
    reference = part("d", reference_card_vs_cpu, goldens, physics, dev)
    return {"nvidia_smi": smi, "part_seconds": part_seconds, "trivial_solution_net": trivial,
            "holo_autoencoder": autoencoder, "unwraps": unwraps, "reference_checkpoint": reference,
            "launches": {"border_lines": trivial["ring_launches"]}}


def main() -> int:
    with Phase("device") as phase:
        smi = phase_device()
        name = torch.cuda.get_device_name(0)
        phase.info = {
            "name": name, "nvidia_smi": smi, "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        }
        if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
            _die("TF32 is on: the port must run fp32 convolutions and products", 1)
        peak_fp32, peak_bf16, peak_bytes = next(
            (v for k, v in PEAKS.items() if k in name), PEAKS["H100"])
        peak_flops = {"fp32": peak_fp32, "bf16": peak_bf16}

    with Phase("build") as phase:
        seconds = _BUILDS["asm"].result()
        asm_cuda._lib()
        zstd_seconds = _BUILDS["zstd"].result()
        phase.info = {"nvcc_seconds": seconds, "cxx_seconds": zstd_seconds,
                      "removed_stale": _BUILDS["removed_stale"],
                      "build_dir": _build.BUILD_DIR, "asm_propagate_ptxas": _build.ptxas_lines("asm_propagate")}

    with open(os.path.join(REPO, "checkpoints", "config.json")) as f:
        cfg = ExperimentConfig.from_json(f.read())
    physics = cfg.physics
    dev = torch.device("cuda")
    train_bank = synth.golden_digit_bank(load_golden_suite(), subset=synth.GOLDEN_TRAIN_DIGITS)

    with Phase("kernels") as phase:
        rows = check_kernels(physics, dev)
        phase.info = {"checks": rows}

    with Phase("slice") as phase:
        goldens = load_golden_suite()
        net = seeded_weights_(StyleTransferNet(width=cfg.model.width), seed=0).to(dev).eval()
        asm_cuda.reset_launches()
        metrics, out = drive_slice(net, goldens, cfg, dev)
        torch.cuda.synchronize()
        launches = dict(asm_cuda.LAUNCHES)
        if not all(launches[k] > 0 for k in ("asm_const", "asm_dynamic")):
            _die(f"the main path did not launch every kernel: {launches}", 1)
        check_slice_outputs(metrics, out, goldens.batch_size)
        card_vs_cpu = compare_card_cpu(net, goldens, cfg, batch=10)
        phase.info = {
            "width": cfg.model.width, "launches": launches,
            "mean_psnr_random_weights": metrics["mean_psnr"],
            "r2_random_weights": metrics["r2"],
            "card_vs_cpu": card_vs_cpu,
        }

    with Phase("refine") as phase:
        grad_rows = check_function_grads(physics, dev)
        anchored = refine_card_vs_cpu(goldens, physics, dev)
        asm_cuda.reset_launches()
        t0 = time.monotonic()
        refined = evaluate_golden_suite(net, goldens, cfg, refine_steps=REFINE_STEPS, device=dev)
        torch.cuda.synchronize()
        suite_seconds = time.monotonic() - t0
        refine_launches = dict(asm_cuda.LAUNCHES)
        want = goldens.n_batches * (REFINE_STEPS + 1)
        if refine_launches["asm_dynamic"] != want:
            _die(f"the refined suite launched asm_dynamic {refine_launches['asm_dynamic']} times, "
                 f"want {want}", 1)
        for key in ("mean_psnr", "mean_mae", "r2", "heldout_mean_psnr"):
            if not math.isfinite(refined[key]):
                _die(f"refined suite metric {key} is not finite: {refined[key]}", 1)
        phase.info = {
            "gradient_checks": grad_rows, "card_vs_cpu_batch_10": anchored,
            "launches": refine_launches, "refined_suite_seconds": suite_seconds,
            "refined_mean_psnr_random_weights": refined["mean_psnr"],
            "unrefined_mean_psnr_random_weights": metrics["mean_psnr"],
        }

    with Phase("conv_kernels") as phase:
        rest = _BUILDS["rest"].result()
        conv_stack._lib()
        reflect_border._lib()
        halo_conv._lib()
        conv_rows = check_conv_kernels(dev)
        phase.info = {"nvcc_seconds": rest, **{f"{src}_ptxas": _build.ptxas_lines(src) for src in rest},
                      "conv_checks": conv_rows}

    # The parallel phase's gloo world and the export phase's exports,
    # started once every kernel is built: they run beside the phases
    # between (the world's ranks then wait for their phase). Nothing before
    # the timing phase times what the kernels line prints.
    parallel_world = ParallelWorld(*parallel_inputs(cfg), train_bank)
    exports = Exports(goldens.content_holo[10])

    with Phase("quant") as phase:
        scales = quant.calibrate_scales(
            net, golden_contents(goldens), goldens.style_mean, goldens.style_std, device=dev)
        bf16 = torch.bfloat16
        quant.set_fused_stacks("on")
        conv_stack.reset_launches()
        metrics_on = evaluate_golden_suite(
            net, goldens, cfg, quant_scales=scales, dtype=bf16, device=dev)
        torch.cuda.synchronize()
        launches.update(conv_stack.LAUNCHES)
        if not all(launches[k] > 0 for k in conv_stack.LAUNCHES):
            _die(f"the int8 path did not launch both stack kernels: {conv_stack.LAUNCHES}", 1)
        tc_launches = dict(conv_stack.TC_LAUNCHES)
        if tc_launches != conv_stack.LAUNCHES:
            _die(f"the int8 path ran a stack off the tensor cores: {tc_launches} of "
                 f"{conv_stack.LAUNCHES}", 1)
        args = (goldens.content_holo[10], goldens.style_mean, goldens.style_std,
                float(goldens.distance_style[10].reshape(-1)[0]), physics)
        net_cpu = copy.deepcopy(net).cpu()
        quant_card_vs_cpu = {
            _dt(dt): int8_path_card_vs_cpu(net, net_cpu, args, scales, dt)
            for dt in (torch.float32, bf16)
        }
        no_int8 = [retrieval_step(n, *args, quant_scales={}, dtype=torch.float32, device=d)
                   for n, d in ((net, "cuda"), (net_cpu, "cpu"))]
        quant_card_vs_cpu["float32_no_int8"] = compare_outputs(
            *no_int8, SLICE_AMP_TOL, SLICE_DIST_TOL, SLICE_PHASE_TOL, SLICE_PHASE_FRACTION,
            "the stacks-on path without int8 convs on the card and the CPU")
        quant.set_fused_stacks("off")
        metrics_off = evaluate_golden_suite(
            net, goldens, cfg, quant_scales=scales, dtype=bf16, device=dev)
        quant.set_fused_stacks("auto")
        phase.info = {
            "n_scales": len(scales),
            "launches": {k: launches[k] for k in conv_stack.LAUNCHES},
            "tensor_core_launches": tc_launches,
            "stacks_on_random_weights": suite_summary(metrics_on),
            "stacks_off_random_weights": suite_summary(metrics_off),
            "fp32_random_weights": {"mean_psnr": metrics["mean_psnr"], "r2": metrics["r2"]},
            "card_vs_cpu_batch_10": quant_card_vs_cpu,
        }

    with Phase("reflect") as phase:
        args = (goldens.content_holo[10], goldens.style_mean, goldens.style_std,
                float(goldens.distance_style[10].reshape(-1)[0]), physics)
        set_reflect_backend("cuda")
        reflect_border.reset_launches()
        with recording_ring_layers() as ring_layers_of_step:
            r_cuda = retrieval_step(net, *args, device=dev)
        torch.cuda.synchronize()
        launches.update(reflect_border.LAUNCHES)
        set_reflect_backend("matpad")
        r_matpad = retrieval_step(net, *args, device=dev)
        set_reflect_backend("auto")
        if launches["border_lines"] != REFLECT_CONVS:
            _die(f"the ring launched {launches['border_lines']} times a step, want {REFLECT_CONVS}", 1)
        # Two fp32 conv algorithms on the card: the tolerances of card vs CPU.
        phase.info = {
            "launches_per_step": launches["border_lines"],
            "ring_layers_of_step": ring_layers_of_step,
            "cuda_vs_matpad_batch_10": compare_outputs(
                r_cuda, r_matpad, SLICE_AMP_TOL, SLICE_DIST_TOL, SLICE_PHASE_TOL,
                SLICE_PHASE_FRACTION, "reflect backends cuda and matpad"),
        }

    with Phase("halo") as phase:
        halo_conv.reset_launches()
        halo_args, halo_outs = drive_halo(dev)
        torch.cuda.synchronize()
        launches.update(halo_conv.LAUNCHES)
        if not all(launches[k] > 0 for k in halo_conv.LAUNCHES):
            _die(f"the halo path did not launch both kernels: {halo_conv.LAUNCHES}", 1)
        check_halo_outputs(halo_args, halo_outs)
        del halo_args, halo_outs
        halo_rows = check_halo_kernels(dev)
        halo_card_vs_cpu = check_halo_card_vs_cpu(dev)
        phase.info = {
            "launches": {k: launches[k] for k in halo_conv.LAUNCHES},
            "checks": halo_rows, "card_vs_cpu": halo_card_vs_cpu,
        }

    with Phase("golden") as phase:
        fast_net, fast_cfg, fast_style, fast_scales, fast_records = load_fast(dev)
        golden_readings, golden_launches, golden_seconds = run_golden(
            fast_net, goldens, fast_cfg, fast_style, fast_scales, fast_records, dev)
        phase.info = {"release": "checkpoints/fast", "width": fast_cfg.model.width,
                      "readings": golden_readings, "launches": golden_launches,
                      "seconds_by_path": golden_seconds}

    with Phase("release") as phase:
        release_info = drive_release(goldens, dev, smi)
        domain_releases = {tag: load_domain_release(tag) for tag in DOMAINS}
        phase.info = {**release_info, "domain_reads": {t: r[1] for t, r in domain_releases.items()}}

    with Phase("narrow_releases") as phase:
        narrow_info = drive_narrow_releases(goldens, dev, smi)
        phase.info = narrow_info

    with Phase("serve") as phase:
        serve_info = drive_serve(fast_net, fast_cfg, fast_style, fast_scales, goldens, dev, name, smi)
        serve_info["rbc_release"] = drive_serve_domain(dev, smi)
        phase.info = serve_info

    with Phase("stream") as phase:
        stream_info = drive_stream(fast_net, fast_cfg, fast_style, goldens, dev, smi)
        phase.info = stream_info

    with Phase("eval") as phase:
        eval_info = drive_eval(fast_records, smi)
        phase.info = eval_info

    with Phase("mat") as phase:
        mat_info = drive_mat(dev, domain_releases["rbc"][0])
        phase.info = mat_info

    with Phase("domain") as phase:
        domain_info = drive_domain(domain_releases, dev, smi)
        phase.info = domain_info

    with Phase("export") as phase:
        export_info = drive_export(exports, fast_net, fast_cfg, fast_style, fast_scales, fast_records, goldens,
                                   dev, smi)
        phase.info = export_info

    with Phase("commands") as phase:
        commands_info = drive_commands(fast_net, fast_cfg, fast_style, goldens, dev, name, smi)
        phase.info = commands_info

    with Phase("train") as phase:
        part_seconds = {}

        def part(name, fn, *args):
            t0 = time.monotonic()
            out = fn(*args)
            part_seconds[name] = time.monotonic() - t0
            return out

        train_run = part("a", drive_train, cfg, train_bank, dev)
        train_cmp = part("b", train_step_card_vs_cpu, cfg, train_bank, dev)
        train_synth = part("c", synthesis_card_vs_cpu, cfg, train_bank, dev)
        ring_grad_rows = part("d_layers", ring_gradients, ring_layers_of_step, dev)
        train_ring = part("d_step", train_step_ring, cfg, train_cmp, dev)
        train_timing = part("e", learn_and_time, cfg, train_bank, dev)
        train_w125 = part("f", drive_train_w125, train_bank, dev)
        train_mixed = part("g_h", drive_train_mixed, cfg, train_bank, train_cmp, train_timing, dev, peak_flops,
                           peak_bytes)
        for k in ("params", "disc_params", "batch", "anchor", "card_grads"):
            train_cmp.pop(k)
        phase.info = {"card": smi, "width": cfg.model.width, "part_seconds": part_seconds, "run": train_run,
                      "card_vs_cpu_step": train_cmp, "synthesis_card_vs_cpu": train_synth,
                      "ring_gradients": ring_grad_rows, "ring_train_step": train_ring,
                      "learn_and_time": train_timing, "w125": train_w125, "mixed_precision": train_mixed}

    with Phase("parallel") as phase:
        parallel_info = drive_parallel(cfg, train_bank, parallel_world, fast_net, fast_cfg, fast_style,
                                       goldens, dev, smi)
        phase.info = parallel_info

    with Phase("ablations") as phase:
        ablation_info = drive_ablations(goldens, physics, dev, smi)
        phase.info = ablation_info

    with Phase("timing") as phase:
        refine_timing = time_refine(goldens, physics, dev)
        halo_ms = time_halo(dev)
        halo_b = halo_bounds(peak_flops, peak_bytes, B_TIMING)
        kw = dict(wavelength=physics.wavelength, pixel_size=physics.pixel_size)
        b = B_TIMING
        xre, xim = random_planes(b, seed=1, device=dev)
        field = torch.complex(xre, xim)
        dist = spread_distances(b, dev)
        timings = {
            "asm_const": (
                median_ms(lambda: asm_cuda.asm_const(xre, xim, SERVING_REFOCUS_M, **kw)),
                median_ms(lambda: asm_cuda.asm_const_plain(xre, xim, SERVING_REFOCUS_M, **kw)),
                median_ms(lambda: propagate_torch(field, SERVING_REFOCUS_M, **kw)),
            ),
            "asm_dynamic": (
                median_ms(lambda: asm_cuda.asm_dynamic(xre, xim, dist, **kw)),
                median_ms(lambda: asm_cuda.asm_dynamic_plain(xre, xim, dist, **kw)),
                median_ms(lambda: propagate_torch(field, dist.reshape(b, 1, 1), **kw)),
            ),
        }
        holo = torch.as_tensor(
            goldens.content_holo.reshape(-1, 1, IMAGE, IMAGE)[np.arange(b) % 100], device=dev
        )
        step = lambda: retrieval_step(  # noqa: E731
            net, holo, goldens.style_mean, goldens.style_std, 0.2, physics, device=dev)
        step_ms = median_ms(step, reps=5, warmup=2)
        by_precision = {
            prec: {
                "asm_const": median_ms(lambda: asm_cuda.asm_const(
                    xre, xim, SERVING_REFOCUS_M, precision=prec, **kw), reps=7),
                "asm_dynamic": median_ms(lambda: asm_cuda.asm_dynamic(
                    xre, xim, dist, precision=prec, **kw), reps=7),
            }
            for prec in TOLERANCES
        }
        # The step's stages, each timed alone on the same batch: the net
        # (encoder, AdaIN, decoder, distance head), the refocus (field,
        # propagate by -d_style, |.| and angle) and the unwrap.
        sm, ss = split_style_vector(
            np.concatenate([goldens.style_mean, goldens.style_std]).astype(np.float32))
        sm, ss = sm.to(dev), ss.to(dev)
        with torch.inference_mode():
            content = torch.sqrt(holo)
            amp_t, ph_t, _ = net.field_retrieval(content, sm, ss, unknown_distance=True)
            _, ph_foc = holo_forward(amp_t, ph_t, -0.2, physics, return_field=True)
            stages_ms = {
                "net": median_ms(lambda: net.field_retrieval(
                    content, sm, ss, unknown_distance=True), reps=5, warmup=1),
                "refocus": median_ms(lambda: holo_forward(
                    amp_t, ph_t, -0.2, physics, return_field=True), reps=5, warmup=1),
                "unwrap": median_ms(lambda: unwrap_phase(ph_foc), reps=5, warmup=1),
            }
        # The conv kernels: kernel, plain version and library call (the cuDNN
        # composition of the same stack in the same dtype, for the tail the
        # port's conv_tail_reference; the ring has no
        # single PyTorch call), bf16 (the int8 path's dtype) and fp32; the
        # ring at the decoder's 128^2 64->64 layer, and in fp32 at each
        # checked layer.
        conv_timings = {}
        for dtype in CONV_TOLERANCES:
            for kname, c_in, widths, run, plain, lib in (
                ("fused_encoder_head", 1, HEAD_WIDTHS, conv_stack.fused_encoder_head,
                 conv_stack.encoder_head_plain, head_library),
                ("fused_conv_tail", 64, TAIL_WIDTHS, conv_stack.fused_conv_tail,
                 conv_stack.conv_tail_plain, conv_stack.conv_tail_reference),
            ):
                a = seeded_stack(b, dtype, c_in, widths, 2, dev)
                conv_timings[kname, dtype] = (
                    median_ms(lambda: run(*a), reps=7), median_ms(lambda: plain(*a), reps=5),
                    median_ms(lambda: lib(*a), reps=7))
                del a
            x, k = ring_inputs(b, RING_LAYERS[0], 2, dev, dtype)
            conv_timings["border_lines", dtype] = (
                median_ms(lambda: reflect_border.border_lines(x, k)),
                median_ms(lambda: reflect_border.border_lines_plain(x, k), reps=7), None)
        ring_layers_ms = {}
        for layer in RING_LAYERS:
            x, k = ring_inputs(b, layer, 2, dev)
            ring_layers_ms["x".join(map(str, layer))] = median_ms(lambda: reflect_border.border_lines(x, k))
        del x, k
        ring_step = time_ring_step(ring_layers_of_step, peak_flops, peak_bytes, b, dev)
        conv_b = conv_bounds(peak_flops, peak_bytes, b)

        # retrieval_step in int8 with the stacks on, and its stages alone on
        # the same batch; then fp32 with the reflect backend cuda.
        bf16 = torch.bfloat16
        quant.set_fused_stacks("on")
        q_step = lambda: retrieval_step(  # noqa: E731
            net, holo, goldens.style_mean, goldens.style_std, 0.2, physics,
            quant_scales=scales, device=dev)
        q_step_ms = median_ms(q_step, reps=5, warmup=2)
        qkw = dict(scales=scales, compute_dtype=bf16)
        with torch.inference_mode():
            feat = quant.quant_encode(net.encoder, content, **qkw)
            t_feat = adain_with_stats(feat, sm, ss)
            g_out = quant.quant_decode(net.decoder, t_feat, **qkw)
            q_amp, q_ph = g_out[:, 0:1], g_out[:, 1:2]
            _, q_ph_foc = holo_forward(q_amp, q_ph, -0.2, physics, return_field=True)
            q_stages_ms = {
                "encoder": median_ms(lambda: quant.quant_encode(net.encoder, content, **qkw),
                                   reps=5, warmup=1),
                "adain": median_ms(lambda: adain_with_stats(feat, sm, ss), reps=5, warmup=1),
                "decoder": median_ms(lambda: quant.quant_decode(net.decoder, t_feat, **qkw),
                                   reps=5, warmup=1),
                "distance_head": median_ms(lambda: net.distance_g(calc_mean_std(feat), dtype=bf16),
                                         reps=5, warmup=1),
                "refocus": median_ms(lambda: holo_forward(
                    q_amp, q_ph, -0.2, physics, return_field=True), reps=5, warmup=1),
                "unwrap": median_ms(lambda: unwrap_phase(q_ph_foc), reps=5, warmup=1),
            }
        # The same step and its network stages with the stacks off (the
        # default, as in the JAX package), on the same batch.
        quant.set_fused_stacks("off")
        q_off_step_ms = median_ms(q_step, reps=5, warmup=2)
        with torch.inference_mode():
            feat_off = quant.quant_encode(net.encoder, content, **qkw)
            t_off = adain_with_stats(feat_off, sm, ss)
            q_off_stages_ms = {
                "encoder": median_ms(lambda: quant.quant_encode(net.encoder, content, **qkw),
                                   reps=5, warmup=1),
                "decoder": median_ms(lambda: quant.quant_decode(net.decoder, t_off, **qkw),
                                   reps=5, warmup=1),
            }
        quant.set_fused_stacks("auto")
        set_reflect_backend("cuda")
        r_step_ms = median_ms(step, reps=5, warmup=2)
        set_reflect_backend("auto")

        # The least time for one propagate of b images, in each precision
        # mode: the larger of its operations over the card's peak rate for
        # their type and the bytes (x and y planes, factors, transfer
        # planes, distances; each once) over its memory rate.
        h = w = IMAGE
        fh, fw = 2 * h, 2 * w
        cmacs = fh * h * w + fh * w * fw + h * fh * fw + h * fw * w
        flops = 8.0 * cmacs * b
        factor_bytes = 4 * 2 * (fh * h + w * fw + h * fh + fw * w)
        io_bytes = 4 * 2 * 2 * b * h * w + factor_bytes
        bytes_by = {"asm_const": io_bytes + 4 * 2 * fh * fw, "asm_dynamic": io_bytes + 4 * fh * fw + 4 * b}
        bounds = {}
        for k in timings:
            for prec, (n_products, kind) in PRODUCTS.items():
                t_ops = n_products * flops / peak_flops[kind] * 1e3
                t_bytes = bytes_by[k] / peak_bytes * 1e3
                bounds[k, prec] = (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")
        phase.info = {
            "B": b, "precision": "high",
            "kernel_ms": {k: v[0] for k, v in timings.items()},
            "plain_ms": {k: v[1] for k, v in timings.items()},
            "torch_fft_ms": {k: v[2] for k, v in timings.items()},
            "bound_ms": {k: bounds[k, "high"][0] for k in timings},
            "peak_flops": peak_flops, "peak_bytes_per_s": peak_bytes,
            "kernel_ms_by_precision": by_precision,
            "bound_ms_by_precision": {
                prec: {k: bounds[k, prec][0] for k in timings} for prec in PRODUCTS},
            "retrieval_step_ms": step_ms, "retrieval_holograms_per_s": b / step_ms * 1e3,
            "step_stages_ms": stages_ms,
            "int8_stacks_on_step_ms": q_step_ms,
            "int8_stacks_on_holograms_per_s": b / q_step_ms * 1e3,
            "int8_stacks_on_stages_ms": q_stages_ms,
            "int8_stacks_off_step_ms": q_off_step_ms,
            "int8_stacks_off_holograms_per_s": b / q_off_step_ms * 1e3,
            "int8_stacks_off_stages_ms": q_off_stages_ms,
            "fp32_reflect_cuda_step_ms": r_step_ms,
            "fp32_reflect_cuda_holograms_per_s": b / r_step_ms * 1e3,
            "conv_kernel_ms": {f"{k}/{_dt(d)}": v for (k, d), v in conv_timings.items()},
            "ring_fp32_ms_by_layer": ring_layers_ms,
            "ring_fp32_step": ring_step,
            "conv_bound_ms": {f"{k}/{_dt(d)}": v for (k, d), v in conv_b.items()},
            "refine": refine_timing,
            "halo_ms": halo_ms,
            "halo_bound_ms": {f"{p}/{_dt(d)}": v for (p, d), v in halo_b.items()},
        }

    sources = "style_transfer_based_holographic_imaging_tpu_torch/kernels/csrc/asm_propagate.cu"
    replaces = {
        "asm_const": "style_transfer_based_holographic_imaging_tpu/kernels/asm_pallas.py:212",
        "asm_dynamic": "style_transfer_based_holographic_imaging_tpu/kernels/asm_pallas.py:252",
    }
    kernels = []
    for k in ("asm_const", "asm_dynamic"):
        mine = [r for r in rows if r["kernel"] == k]
        at_default = [r for r in mine if r["shape"] == [b, IMAGE, IMAGE] and r["precision"] == "high"][0]
        kernels.append({
            "name": k, "route": "cuda", "source": sources, "replaces": replaces[k],
            "op": f"{library.NAMESPACE}::{k}",
            "launches": launches[k],
            "max_abs_err": at_default["max_abs_err"],
            "max_rel_err": max(r["rel_err_vs_plain"] for r in mine if r["precision"] == "high"),
            "tol": TOLERANCES["high"],
            "rel_err_by_precision": {
                p: max(r["rel_err_vs_plain"] for r in mine if r["precision"] == p)
                for p in TOLERANCES
            },
            "tol_by_precision": TOLERANCES,
            "ms": timings[k][0], "plain_ms": timings[k][1],
            "bound_ms": bounds[k, "high"][0], "bound_by": bounds[k, "high"][1],
            "ms_by_precision": {p: by_precision[p][k] for p in PRODUCTS},
            "bound_ms_by_precision": {p: bounds[k, p][0] for p in PRODUCTS},
            "library_ms": timings[k][2],
            "launches_by_path": {"slice": launches[k], "refine": refine_launches[k],
                                 "golden": golden_launches[k], "release": release_info["launches"][k],
                                 "narrow_releases": narrow_info["launches"][k],
                                 "serve": serve_info["launches"][k],
                                 "stream": stream_info["launches"][k],
                                 "eval": eval_info["launches"][k],
                                 "eval_refine": eval_info["refine_launches"][k],
                                 "mat": mat_info["launches"][k],
                                 "domain": domain_info["launches"][k],
                                 "export": export_info["launches"][k],
                                 "synth_bench": commands_info["synth_bench"]["launches"][k],
                                 "sweep": commands_info["sweep"]["launches"][k],
                                 "train": train_run["launches"][k],
                                 "parallel": parallel_info["launches"][k],
                                 "pipeline_and_sharded_refocus": parallel_info["pipeline_launches"][k]},
            **({"refine_step_ms": refine_timing["step_ms"],
                "refine_step_ms_torch_backend": refine_timing["torch_backend_step_ms"],
                "refine_forward_share": refine_timing["forward_kernel_share"]}
               if k == "asm_dynamic" else {}),
        })
    csrc = "style_transfer_based_holographic_imaging_tpu_torch/kernels/csrc/"
    jk = "style_transfer_based_holographic_imaging_tpu/kernels/"
    conv_meta = {
        # name: (source, replaces, the dtype of its path)
        "fused_encoder_head": (csrc + "conv_stack.cu", jk + "conv_stack.py:195", torch.bfloat16),
        "fused_conv_tail": (csrc + "conv_stack.cu", jk + "conv_stack.py:122", torch.bfloat16),
        "border_lines": (csrc + "reflect_border.cu", jk + "reflect_border.py:97", torch.float32),
    }
    ring_train = train_mixed["ring_bf16_step"]
    remat_launches = train_mixed["ring_launches"]
    extras = {
        "border_lines": {"step_fp32_ms": ring_step["step_ms"],
                         "step_fp32_bound_ms": ring_step["step_bound_ms"],
                         "step_convs": ring_step["convs"],
                         "train_bf16_B": cfg.data.batch_size,
                         "train_bf16_step_ms": ring_train["step_ms"],
                         "train_bf16_step_plain_ms": ring_train["step_plain_ms"],
                         "train_bf16_step_bound_ms": ring_train["step_bound_ms"],
                         "train_bf16_step_convs": ring_train["convs"],
                         "train_bf16_worst_bf16_ulps": train_mixed["bf16_card_vs_cpu"]["ring_worst_bf16_ulps"],
                         "launches_by_path": {"reflect": launches["border_lines"],
                                              "domain": domain_info["launches"]["border_lines"],
                                              "ablations": ablation_info["launches"]["border_lines"],
                                              "parallel": parallel_info["launches"]["border_lines"],
                                              "pipeline_and_sharded_refocus":
                                                  parallel_info["pipeline_launches"]["border_lines"],
                                              "train_step_cuda_ring": train_ring["launches"],
                                              "train_bf16_step_cuda_ring": remat_launches["plain"],
                                              "train_bf16_remat_step_cuda_ring": remat_launches["remat"]},
                         "gradient_max_rel_err": max(r["rel_err_vs_matpad"] for r in ring_grad_rows)},
    }
    for k, (source, where, dt) in conv_meta.items():
        mine = [r for r in conv_rows if r["kernel"] == k]
        at = [r for r in mine if r["B"] == b and r["dtype"] == _dt(dt)
              and r["layer"] in (None, RING_LAYERS[0])][0]
        kernels.append({
            "name": k, "route": "cuda", "source": source, "replaces": where,
            "op": f"{library.NAMESPACE}::{k}",
            "launches": launches[k], "dtype": _dt(dt),
            "max_abs_err": at["max_abs_err"],
            "max_rel_err": max(r["rel_err_vs_plain"] for r in mine if r["dtype"] == _dt(dt)),
            "tol": CONV_TOLERANCES[dt],
            "rel_err_by_dtype": {
                _dt(d): max(r["rel_err_vs_plain"] for r in mine if r["dtype"] == _dt(d))
                for d in CONV_TOLERANCES
            },
            "tol_by_dtype": {_dt(d): t for d, t in CONV_TOLERANCES.items()},
            "ms": conv_timings[k, dt][0], "plain_ms": conv_timings[k, dt][1],
            "bound_ms": conv_b[k, dt][0], "bound_by": conv_b[k, dt][1],
            "ms_by_dtype": {_dt(d): conv_timings[k, d][0] for d in CONV_TOLERANCES},
            "plain_ms_by_dtype": {_dt(d): conv_timings[k, d][1] for d in CONV_TOLERANCES},
            "bound_ms_by_dtype": {_dt(d): conv_b[k, d][0] for d in CONV_TOLERANCES},
            "library_ms": conv_timings[k, dt][2],
            "library_ms_by_dtype": {_dt(d): conv_timings[k, d][2] for d in CONV_TOLERANCES},
            **({"launches_by_path": {"quant": launches[k], "golden": golden_launches[k],
                                     "release": release_info["launches"][k],
                                     "narrow_releases": narrow_info["launches"][k],
                                     "domain": domain_info["launches"][k],
                                     "export_int8": export_info["int8_launches"][k]}}
               if k in golden_launches else {}),
            **extras.get(k, {}),
        })
    halo_where = {"halo_conv_tail": jk + "halo_conv.py:105",
                  "halo_conv_tail_static": jk + "halo_conv.py:175"}
    bf16, bh = torch.bfloat16, HALO_BH[0]
    for k, where in halo_where.items():
        mine = [r for r in halo_rows if r["kernel"] == k]
        at = [r for r in mine if r["B"] == b and r["dtype"] == _dt(bf16) and r["C"] == 64
              and r["bh"] == bh][0]
        kernels.append({
            "name": k, "route": "cuda", "source": csrc + "halo_conv.cu", "replaces": where,
            "op": f"{library.NAMESPACE}::{HALO_OPS[k]}",
            "launches": launches[k], "dtype": _dt(bf16), "bh": bh, "C": 64,
            "max_abs_err": at["max_abs_err"],
            "max_rel_err": max(r["rel_err_vs_plain"] for r in mine if r["dtype"] == _dt(bf16)),
            "tol": CONV_TOLERANCES[bf16],
            "rel_err_by_dtype": {
                _dt(d): max(r["rel_err_vs_plain"] for r in mine if r["dtype"] == _dt(d))
                for d in CONV_TOLERANCES
            },
            "tol_by_dtype": {_dt(d): t for d, t in CONV_TOLERANCES.items()},
            "ms": halo_ms[_dt(bf16)][f"{HALO_ROWS[k]}_bh{bh}"],
            "plain_ms": halo_ms[_dt(bf16)][f"plain_bh{bh}"],
            "bound_ms": halo_b["function", bf16][0], "bound_by": halo_b["function", bf16][1],
            "library_ms": halo_ms[_dt(bf16)]["xla_tail"],
            "interior_ms": halo_ms[_dt(bf16)][f"{HALO_ROWS[k]}_interior_bh{bh}"],
            "interior_plain_ms": halo_ms[_dt(bf16)][f"plain_interior_bh{bh}"],
            "interior_bound_ms": halo_b["interior", bf16][0],
            "ms_by_dtype_bh": {f"{d}/bh{h}": halo_ms[d][f"{HALO_ROWS[k]}_bh{h}"]
                               for d in halo_ms for h in HALO_BH},
            "bound_ms_by_dtype": {_dt(d): halo_b["function", d][0] for d in CONV_TOLERANCES},
        })
    emit({"wall_seconds": round(time.monotonic() - _t_start, 3)})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    watchdog = threading.Timer(TOTAL_BUDGET_S + 5.0, _die, args=("the run overran its total budget", 3))
    watchdog.daemon = True
    watchdog.start()
    try:
        code = main()
    except Exception as e:  # noqa: BLE001 — the children go too, with a line naming the error
        import traceback

        traceback.print_exc()
        _die(f"the run failed: {type(e).__name__}: {e}", 1)
    watchdog.cancel()
    sys.exit(code)
