"""Losses (port of the JAX package's ``train/losses.py``).

Only ``tv_loss`` so far: physics refinement regularises the phase with it.
The generator's other terms come with the training slice.
"""

from __future__ import annotations

import torch

__all__ = ["tv_loss"]


def tv_loss(img: torch.Tensor) -> torch.Tensor:
    """Order-1 total variation with the reference's normalisation: summed
    over the batch, divided by H*W. The JAX package's ``tv_loss`` with its
    defaults; its ``norm`` and ``order`` options wait for the training
    slice."""
    dh = img[..., 1:, :] - img[..., :-1, :]
    dw = img[..., :, 1:] - img[..., :, :-1]
    return (dh.abs().sum() + dw.abs().sum()) / img.shape[-2] / img.shape[-1]
