"""Experimental-domain evaluation on synthesized, unseen phase objects (the
JAX package's ``pipelines/domain_eval.py``).

The bead and red-blood-cell releases have no bundled golden suite. Their
gate: synthesize holograms from a held-out object bank (``data.synth``
``bead_bank`` / ``rbc_bank`` with a seed training never used), run field
retrieval and score the golden suite's metrics, the refocused phase's mean
PSNR and MAE against the known synthetic object and the distance R² in µm.

The batches are the JAX package's: batch ``i`` is ``synth_batch`` under
``jax.random.fold_in(jax.random.key(seed), i)``, taken here through the
numpy reproduction of that stream (``synth.synth_batch_from_key``). The
domain presets band-limit their transfer function, which neither ASM kernel
takes, so on the card their synthesis and refocus run through ``torch.fft``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from style_transfer_based_holographic_imaging_tpu_torch.config import ExperimentConfig
from style_transfer_based_holographic_imaging_tpu_torch.data.synth import synth_batch_from_key
from style_transfer_based_holographic_imaging_tpu_torch.eval import metrics as metrics_mod
from style_transfer_based_holographic_imaging_tpu_torch.models.net import StyleTransferNet
from style_transfer_based_holographic_imaging_tpu_torch.pipelines.field_retrieval import (
    make_retrieval_fn,
)
from style_transfer_based_holographic_imaging_tpu_torch.pipelines.refine import physics_refine
from style_transfer_based_holographic_imaging_tpu_torch.utils import jax_random

__all__ = ["evaluate_synth_domain"]


def evaluate_synth_domain(
    net: StyleTransferNet,
    config: ExperimentConfig,
    bank: np.ndarray,
    style: Tuple[np.ndarray, np.ndarray],
    *,
    n_batches: int = 8,
    seed: int = 7777,
    refine_steps: int = 0,
    refine_distance: bool = False,
    refine_lr: float = 0.05,
    refine_tv_weight: float = 5e-3,
    dtype: Optional[torch.dtype] = None,
    quant_scales=None,
    device: str | torch.device = "cuda",
) -> Dict[str, Any]:
    """Score ``net`` on ``n_batches`` holograms synthesized from ``bank`` (a
    held-out bank: the numbers measure generalization) under the stream
    keyed ``seed``. ``dtype`` and ``quant_scales`` are ``retrieval_step``'s;
    ``refine_steps`` refines the phase at the known amplitude
    ``config.data.amplitude`` with ``refine_lr`` and ``refine_tv_weight``.
    The metrics stay on the device until the end of the loop."""
    physics = config.physics
    device = torch.device(device)
    fn = make_retrieval_fn(physics, alpha=config.eval.alpha, dtype=dtype,
                           quant_scales=quant_scales, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    sm = torch.as_tensor(np.asarray(style[0]), **f32)
    ss = torch.as_tensor(np.asarray(style[1]), **f32)
    bank_t = torch.as_tensor(np.asarray(bank, np.float32), device=device)
    # One style plane a domain: a host float, the refocus's static distance.
    d_style_net = float(physics.to_network_units(float(config.data.style_distances[0])))

    psnr_list, mae_list, d_true_all, d_pred_all = [], [], [], []
    base = jax_random.key(seed)
    for i in range(n_batches):
        batch = synth_batch_from_key(jax_random.fold_in(base, i), bank_t, config.data, physics,
                                     return_gt=True)
        holo = batch["content_holo"] ** 2  # retrieval takes intensity
        out = fn(net, holo, sm, ss, d_style_net)
        if refine_steps:
            refined = physics_refine(
                torch.full_like(out["amp_foc"], config.data.amplitude),
                out["ph_foc"],
                out["distance_pred"],
                batch["content_holo"],
                physics,
                steps=refine_steps,
                lr=refine_lr,
                tv_weight=refine_tv_weight,
                optimize_amp=False,
                refine_distance=refine_distance,
                device=device,
            )
            out = dict(out, ph_foc=refined["phase"])
            if refine_distance:
                out["distance_pred"] = refined["distance"]
        gt_phase = metrics_mod.zero_mean(batch["phase_content"])
        ph_foc = metrics_mod.zero_mean(out["ph_foc"])
        psnr_list.append(metrics_mod.psnr(ph_foc, gt_phase))
        mae_list.append(metrics_mod.mae(ph_foc, gt_phase))
        d_true_all.append(batch["distance_content"].reshape(-1))
        d_pred_all.append(out["distance_pred"].reshape(-1))

    psnr_list = torch.stack(psnr_list).cpu().tolist()
    mae_list = torch.stack(mae_list).cpu().tolist()
    d_true = torch.cat(d_true_all).cpu().numpy()
    d_pred = torch.cat(d_pred_all).cpu().numpy()
    um = metrics_mod.distances_to_um(np.stack([d_true, d_pred], axis=1), physics)
    return {
        "mean_psnr": float(np.mean(psnr_list)),
        "mean_mae": float(np.mean(mae_list)),
        "r2": float(metrics_mod.r2_score(um[:, 0], um[:, 1])),
        "psnr_per_batch": psnr_list,
        "mae_per_batch": mae_list,
        "distance_true_um": um[:, 0].tolist(),
        "distance_pred_um": um[:, 1].tolist(),
        "n_samples": int(d_true.size),
        # synthesized holograms of synthetic objects, never measured data
        "synthetic_eval": True,
    }
