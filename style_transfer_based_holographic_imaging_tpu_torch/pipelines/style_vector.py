"""Representative style vectors (the JAX package's ``pipelines/style_vector.py``).

A style vector is the AdaIN statistics of the encoder's relu4_1 features
over holograms recorded at the domain's style distance: the batch-averaged
per-sample (mean, std), each ``(1, 1, 1, C)`` (the JAX package's NHWC
layout, as ``style_vector.npz`` stores it). A newly trained encoder needs
its own. ``extract_style_vector`` synthesizes the style-plane holograms of a
bank under the JAX package's ``jax.random`` stream (``synth_batch_from_key``),
so its vector is the JAX package's for the same weights;
``style_vector_from_holograms`` takes measured ones
(``data.mat_sampler.MeasuredHologramSampler.style_batches``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from style_transfer_based_holographic_imaging_tpu_torch.config import ExperimentConfig
from style_transfer_based_holographic_imaging_tpu_torch.data.synth import synth_batch_from_key
from style_transfer_based_holographic_imaging_tpu_torch.models.net import StyleTransferNet
from style_transfer_based_holographic_imaging_tpu_torch.ops.stats import calc_mean_std
from style_transfer_based_holographic_imaging_tpu_torch.utils import jax_random

__all__ = ["extract_style_vector", "style_vector_from_holograms", "save_style_vector"]


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).cpu().numpy()


@torch.inference_mode()
def style_vector_from_holograms(net: StyleTransferNet, sqrt_holos) -> Tuple[np.ndarray, np.ndarray]:
    """(mean, std), each ``(1, 1, 1, C)`` numpy: the batch-averaged relu4_1
    statistics of NCHW sqrt-intensity style-plane holograms, on the net's
    device."""
    p = next(net.parameters())
    feats = net.encode(torch.as_tensor(sqrt_holos, dtype=torch.float32, device=p.device))
    m, s = calc_mean_std(feats)
    return _nhwc(m.mean(dim=0, keepdim=True)), _nhwc(s.mean(dim=0, keepdim=True))


def extract_style_vector(
    net: StyleTransferNet,
    config: ExperimentConfig,
    bank: np.ndarray,
    *,
    n_batches: int = 32,
    seed: int = 1234,
) -> Tuple[np.ndarray, np.ndarray]:
    """A style vector from ``n_batches`` synthesized style-plane batches of
    ``bank``'s objects at the domain's style distance(s), batch ``i`` keyed
    ``fold_in(key(seed), i)``, on the net's device."""
    device = next(net.parameters()).device
    bank_t = torch.as_tensor(np.asarray(bank, np.float32), device=device)
    base = jax_random.key(seed)
    means, stds = [], []
    for i in range(n_batches):
        batch = synth_batch_from_key(jax_random.fold_in(base, i), bank_t, config.data, config.physics)
        m, s = style_vector_from_holograms(net, batch["style_holo"])
        means.append(m)
        stds.append(s)
    return (np.mean(np.concatenate(means), axis=0, keepdims=True),
            np.mean(np.concatenate(stds), axis=0, keepdims=True))


def save_style_vector(mean: np.ndarray, std: np.ndarray, path: str):
    """Save as ``.npz`` with ``mean`` and ``std`` in fp32."""
    np.savez(path, mean=mean.astype(np.float32), std=std.astype(np.float32))
