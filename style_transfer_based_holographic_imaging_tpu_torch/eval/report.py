"""Evaluation reports (the JAX package's ``eval/report.py``): the per-sample
montages, the distance box plot and the ``metrics.jsonl`` line.

A montage is the reference's 2 x 4 grid
``[content | A_t | A_gt | A_foc ; 0 | phi_t | phi_gt | phi_foc]`` as 8-bit
PNG (torchvision ``save_image``'s rounding), ``{i}_test.png`` numbered from
1; the box plot is ``distance_prediction.png``, predicted distances grouped
by true distance. Host code: PIL and matplotlib are imported where a report
is written.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np

__all__ = ["save_montages", "save_distance_boxplot", "save_metrics_jsonl", "to_image"]


def to_image(x: np.ndarray) -> np.ndarray:
    """float array -> uint8 with torchvision save_image semantics:
    clamp to [0, 1], scale by 255, round-half-up."""
    x = np.clip(np.asarray(x, np.float32), 0.0, 1.0)
    return (x * 255.0 + 0.5).clip(0, 255).astype(np.uint8)


def save_montages(batches: List[Dict[str, np.ndarray]], save_dir: str, ext: str = ".png"):
    """Write the per-sample 2x4 montage grid, numbered 1..N
    (``{i}_test.png``)."""
    from PIL import Image

    os.makedirs(save_dir, exist_ok=True)
    idx = 0
    for batch in batches:
        b = batch["content"].shape[0]
        for j in range(b):
            top = np.concatenate(
                [
                    batch["content"][j, 0],
                    batch["amp_field"][j, 0],
                    batch["gt_amplitude"][j, 0],
                    batch["amp_foc"][j, 0],
                ],
                axis=1,
            )
            bot = np.concatenate(
                [
                    np.zeros_like(batch["content"][j, 0]),
                    batch["ph_field"][j, 0],
                    batch["gt_phase"][j, 0],
                    batch["ph_foc"][j, 0],
                ],
                axis=1,
            )
            grid = np.concatenate([top, bot], axis=0)
            idx += 1
            Image.fromarray(to_image(grid)).save(
                os.path.join(save_dir, f"{idx}_test{ext}")
            )


def save_distance_boxplot(
    d_true_um: Sequence[float], d_pred_um: Sequence[float], save_dir: str
):
    """Horizontal box-plot of predicted distances grouped by true distance."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(save_dir, exist_ok=True)
    d_true = np.round(np.asarray(d_true_um, np.float64), 2)
    d_pred = np.asarray(d_pred_um, np.float64)
    groups: Dict[float, list] = {v: [] for v in np.unique(d_true)}
    for t, p in zip(d_true, d_pred):
        groups[t].append(p)

    fig = plt.figure(figsize=(12, 3))
    plt.boxplot(
        list(groups.values()),
        orientation="horizontal",
        tick_labels=[str(k) for k in groups],
    )
    plt.xlabel("predicted distance (um)")
    plt.ylabel("true distance (um)")
    fig.savefig(os.path.join(save_dir, "distance_prediction.png"), bbox_inches="tight")
    plt.close(fig)


def save_metrics_jsonl(metrics: Dict, save_dir: str, name: str = "metrics.jsonl"):
    """Append one JSON line per evaluation run."""
    os.makedirs(save_dir, exist_ok=True)
    with open(os.path.join(save_dir, name), "a") as f:
        f.write(json.dumps(metrics) + "\n")
