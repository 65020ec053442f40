"""Training losses (port of the JAX package's ``train/losses.py``).

* ``tv_loss``             — total variation (``norm``, ``order``), also the
  refinement's regulariser;
* ``physics_cycle_loss``  — L_phy: the decoded style-plane field propagated
  by the plane separation must reproduce the measured content hologram;
* ``lsgan_d_loss`` / ``lsgan_g_loss`` — least-squares GAN;
* ``distance_loss``       — MSE on the normalized distances;
* ``style_plane_target``  — the true style-plane field of a synthetic
  object, the supervised terms' target.

The cycle propagates with the ``torch`` ASM backend, as the JAX package
forces its ``xla`` backend there, so that the forward and backward physics
are one composition.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from style_transfer_based_holographic_imaging_tpu_torch.config import PhysicsConfig
from style_transfer_based_holographic_imaging_tpu_torch.ops.holo import holo_forward

__all__ = ["tv_loss", "physics_cycle_loss", "lsgan_d_loss", "lsgan_g_loss", "distance_loss",
           "style_plane_target"]


def tv_loss(img: torch.Tensor, norm: bool = False, order: int = 1) -> torch.Tensor:
    """Total variation with the reference's normalisation: summed over the
    batch, divided by H*W. ``order`` p > 1 takes the p-norm of each
    direction's differences; ``norm`` divides by the mean |img| (no
    gradient through it)."""
    dh = img[..., 1:, :] - img[..., :-1, :]
    dw = img[..., :, 1:] - img[..., :, :-1]
    if order == 1:
        tv = dh.abs().sum() + dw.abs().sum()
    else:
        tv = (dh.abs() ** order).sum() ** (1.0 / order) + (dw.abs() ** order).sum() ** (1.0 / order)
    tv = tv / img.shape[-2] / img.shape[-1]
    if norm:
        tv = tv / img.detach().abs().mean()
    return tv


def physics_cycle_loss(amp_style, phase_style, d_content, d_style, content_sqrt_holo,
                       physics: PhysicsConfig) -> torch.Tensor:
    """``mean((|ASM(A_t e^{i phi_t}, d_c - d_s)| - sqrt(content))^2)``, NCHW,
    distances in network units broadcastable to ``(B, 1, 1, 1)``. The
    separation subtracts ``distance_normalize_constant`` once, since
    ``to_metres`` adds it once."""
    d_sep = d_content - d_style - physics.distance_normalize_constant
    amp_prop, _ = holo_forward(amp_style, phase_style, d_sep, physics, return_field=True,
                               asm_backend="torch")
    return torch.mean((amp_prop - content_sqrt_holo) ** 2)


def lsgan_d_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    """Least-squares GAN discriminator loss (real -> 1, fake -> 0)."""
    return 0.5 * (torch.mean((real_logits - 1.0) ** 2) + torch.mean(fake_logits**2))


def lsgan_g_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    """Least-squares GAN generator loss (fake -> 1)."""
    return 0.5 * torch.mean((fake_logits - 1.0) ** 2)


def distance_loss(d_pred: torch.Tensor, d_true: torch.Tensor) -> torch.Tensor:
    """MSE on normalized distances."""
    return torch.mean((d_pred.reshape(-1) - d_true.reshape(-1)) ** 2)


def style_plane_target(amplitude, phase, distance, physics: PhysicsConfig):
    """``(|H|, angle(H))`` of the object ``A exp(i phase)`` propagated by
    ``distance`` ``(B, 1, 1, 1)`` (network units), with no gradient, as the
    JAX package's jitted train step computes it.

    The global phasor ``exp(i d 2 pi / lambda)`` turns by about 2,400 rad at
    the style plane, where one fp32 ulp of the argument is 2.4e-4 rad. Under
    ``jit`` XLA folds the metre conversion's constants into the phasor's:
    the argument is ``(d + c) * fl(fl(k 1e-3) 2 pi / lambda)`` (``c`` and
    ``k`` dropped where they are 0 and 1), not ``fl((d + c) k 1e-3) 2 pi /
    lambda`` as ``holo_forward`` rounds it eagerly. The two differ by a few
    ulps, a constant phase per sample that moves the phase target and its
    gradient by about 1e-3 of their size. The field is turned by that
    difference, so the port trains on the JAX package's target."""
    with torch.no_grad():
        field = holo_forward(amplitude, phase, distance, physics, complex_number=True,
                             asm_backend="torch")
        d = torch.as_tensor(distance, dtype=torch.float32, device=field.device)
        c, k = physics.distance_normalize_constant, physics.distance_normalize
        two_pi_l = float(np.float32(2.0 * math.pi / physics.wavelength))
        eager = physics.to_metres(d) * two_pi_l
        scale = np.float32(1e-3) if k == 1.0 else np.float32(np.float32(k) * np.float32(1e-3))
        folded = (d + c if c else d) * float(np.float32(scale * np.float32(two_pi_l)))
        turn = (folded - eager).double()
        field = field * torch.complex(torch.cos(turn), torch.sin(turn)).to(field.dtype)
        return torch.abs(field), torch.angle(field)
