"""Measured ``.mat``-tree evaluation: the reference's test-split protocol (the
JAX package's ``pipelines/mat_eval.py``).

The test split of a measured tree carries reconstructed ground truth
(``gt_amplitude`` / ``gt_phase`` files beside the holograms). ``evaluate_mat_tree``
indexes it with ``data.mat_loader.HoloMatDataset``, runs fixed-shape batches
through field retrieval and scores the refocused phase against the tree's
own ground truth: the measured counterpart of
``pipelines.domain_eval.evaluate_synth_domain``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from style_transfer_based_holographic_imaging_tpu_torch.config import ExperimentConfig
from style_transfer_based_holographic_imaging_tpu_torch.data.mat_loader import HoloMatDataset
from style_transfer_based_holographic_imaging_tpu_torch.eval import metrics as metrics_mod
from style_transfer_based_holographic_imaging_tpu_torch.models.net import StyleTransferNet
from style_transfer_based_holographic_imaging_tpu_torch.pipelines.field_retrieval import (
    make_retrieval_fn,
)
from style_transfer_based_holographic_imaging_tpu_torch.pipelines.refine import physics_refine

__all__ = ["evaluate_mat_tree"]


def _center_crop(x: np.ndarray, size: int) -> np.ndarray:
    """Centre-crop the trailing two axes to ``(size, size)``."""
    h, w = x.shape[-2:]
    if h == size and w == size:
        return x
    if h < size or w < size:
        raise ValueError(f"frame {h}x{w} smaller than eval size {size}")
    top = (h - size) // 2
    left = (w - size) // 2
    return x[..., top : top + size, left : left + size]


def evaluate_mat_tree(
    net: StyleTransferNet,
    root: str,
    config: ExperimentConfig,
    style: Tuple[np.ndarray, np.ndarray],
    *,
    domain: Optional[str] = None,
    batch_size: int = 4,
    refine_steps: int = 0,
    refine_distance: bool = False,
    dtype: Optional[torch.dtype] = None,
    quant_scales=None,
    device: str | torch.device = "cuda",
) -> Dict[str, Any]:
    """Score ``net`` on a measured ``.mat`` test tree with bundled ground truth.

    ``root`` holds ``test/`` (the RBC flat layout) or the per-fov trees
    (polystyrene / tissue), as ``HoloMatDataset`` reads them, at the
    distances ``config.data.content_distances``. Frames larger
    than ``config.data.image_size`` are centre-cropped, their ground truth
    alike. Every batch has ``batch_size`` frames: the last is padded by
    repeating its last frame, and the padded rows enter no metric.
    ``refine_steps`` refines the phase (at the known amplitude
    ``config.data.amplitude``) against each batch's holograms, as
    ``evaluate_golden_suite`` does.

    Returns the golden suite's metric set: the mean phase PSNR and MAE over
    the batches with ground truth, the distance R² in µm over every frame
    (a frame without ground truth scores its distance only), the per-batch
    lists and the counts.
    """
    physics = config.physics
    size = config.data.image_size
    device = torch.device(device)
    fn = make_retrieval_fn(physics, alpha=config.eval.alpha, dtype=dtype,
                           quant_scales=quant_scales, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    sm = torch.as_tensor(np.asarray(style[0]), **f32)
    ss = torch.as_tensor(np.asarray(style[1]), **f32)
    d_style_net = float(physics.to_network_units(float(config.data.style_distances[0])))

    ds = HoloMatDataset(root, image_set="test", distances=config.data.content_distances, domain=domain)
    if len(ds) == 0:
        raise FileNotFoundError(f"no test-split .mat records under {root}")

    psnr_list, mae_list, d_true_all, d_pred_all = [], [], [], []
    n_scored = 0
    for start in range(0, len(ds), batch_size):
        items = [ds[i] for i in range(start, min(start + batch_size, len(ds)))]
        holo = np.stack([_center_crop(it["holo"], size) for it in items])
        d_true = np.asarray([it["distance"] for it in items], np.float32)
        n_real = len(items)
        if n_real < batch_size:
            holo = np.concatenate([holo, np.stack([holo[-1]] * (batch_size - n_real))], axis=0)
        holo_t = torch.as_tensor(holo, **f32)
        out = fn(net, holo_t, sm, ss, d_style_net)
        if refine_steps:
            refined = physics_refine(
                torch.full_like(out["amp_foc"], config.data.amplitude),
                out["ph_foc"],
                out["distance_pred"],
                torch.sqrt(holo_t),
                physics,
                steps=refine_steps,
                optimize_amp=False,
                refine_distance=refine_distance,
                device=device,
            )
            out = dict(out, ph_foc=refined["phase"])
            if refine_distance:
                out["distance_pred"] = refined["distance"]

        d_true_all.append(physics.to_network_units(d_true))
        d_pred_all.append(out["distance_pred"].reshape(-1)[:n_real])
        gt_items = [i for i, it in enumerate(items) if "gt_phase" in it]
        if gt_items:
            gt = np.stack([_center_crop(items[i]["gt_phase"], size) for i in gt_items])
            ph0 = metrics_mod.zero_mean(out["ph_foc"][gt_items])
            gt0 = metrics_mod.zero_mean(torch.as_tensor(gt, **f32))
            psnr_list.append(metrics_mod.psnr(ph0, gt0))
            mae_list.append(metrics_mod.mae(ph0, gt0))
            n_scored += len(gt_items)

    d_true = np.concatenate(d_true_all)
    d_pred = torch.cat(d_pred_all).cpu().numpy()
    um = metrics_mod.distances_to_um(np.stack([d_true, d_pred], axis=1), physics)
    metrics: Dict[str, Any] = {
        "r2": float(metrics_mod.r2_score(um[:, 0], um[:, 1])),
        "distance_true_um": um[:, 0].tolist(),
        "distance_pred_um": um[:, 1].tolist(),
        "n_samples": int(d_true.size),
        "n_gt_scored": int(n_scored),
        "measured_eval": True,
    }
    if psnr_list:
        psnr_list = torch.stack(psnr_list).cpu().tolist()
        mae_list = torch.stack(mae_list).cpu().tolist()
        metrics["mean_psnr"] = float(np.mean(psnr_list))
        metrics["mean_mae"] = float(np.mean(mae_list))
        metrics["psnr_per_batch"] = psnr_list
        metrics["mae_per_batch"] = mae_list
    return metrics
