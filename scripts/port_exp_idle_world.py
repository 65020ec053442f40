#!/usr/bin/env python3
"""Does ``chip_smoke.py``'s waiting gloo world slow the card's other work?

    python3 scripts/port_exp_idle_world.py

The ``parallel`` phase launches its 2-rank world on ``cuda:0`` after the
``build`` phase; its ranks warm up (imports, CUDA contexts, cuDNN) and then
wait, holding their contexts, until the phase releases them. This times the
flagship's train step (``chip_smoke.time_train_steps``: CUDA-event medians
of 10 steps at B = 32 after 3, and of 3 steps at B = 2 after 1) twice in a
process alone, twice with the world waiting (launched 45 s before), and
once after the world has run and ended. Prints one JSON object, the card's
name and power limit in it.
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as chip  # noqa: E402
from style_transfer_based_holographic_imaging_tpu_torch import ExperimentConfig  # noqa: E402
from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite, synth  # noqa: E402
from style_transfer_based_holographic_imaging_tpu_torch.kernels import _build  # noqa: E402


def timed(cfg, bank, dev) -> dict:
    t0 = time.time()
    out = chip.time_train_steps(cfg, bank, dev, steps=10, warmup=3)
    small = chip.time_train_steps(chip._train_cfg(cfg, batch_size=2), bank, dev, steps=3, warmup=1)
    return {"ms": out["ms"], "b2_step_ms": small["ms"]["step"], "wall_s": time.time() - t0}


def main() -> int:
    card = chip.phase_device()
    _build.build(*_build.SOURCES)
    with open(os.path.join(REPO, "checkpoints", "config.json")) as f:
        cfg = ExperimentConfig.from_json(f.read())
    bank = synth.golden_digit_bank(load_golden_suite(), subset=synth.GOLDEN_TRAIN_DIGITS)
    dev = torch.device("cuda")
    res = {"card": card, "alone_1": timed(cfg, bank, dev), "alone_2": timed(cfg, bank, dev)}
    world = chip.ParallelWorld(*chip.parallel_inputs(cfg), bank)
    time.sleep(45)
    res["world_waiting_1"] = timed(cfg, bank, dev)
    res["world_waiting_2"] = timed(cfg, bank, dev)
    plain, params = chip.parallel_inputs(cfg)
    world.release(chip.parallel_step_pair(plain, params, bank, dev))
    res["world_seconds"] = [r["seconds"] for r in world.join()]
    res["after"] = timed(cfg, bank, dev)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
