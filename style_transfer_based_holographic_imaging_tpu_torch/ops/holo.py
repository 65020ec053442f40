"""Hologram formation and back-propagation (port of the JAX ``ops/holo.py``).

Distances arrive in network units (millimetres under the default config)
and are de-normalized as ``d = ((d + c) * k) * 1e-3``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from style_transfer_based_holographic_imaging_tpu_torch.config import PhysicsConfig
from style_transfer_based_holographic_imaging_tpu_torch.ops.asm import propagate
from style_transfer_based_holographic_imaging_tpu_torch.ops.unwrap import unwrap_phase
from style_transfer_based_holographic_imaging_tpu_torch.utils.misc import static_scalar

__all__ = ["holo_forward", "back_prop"]


def _to_metres_maybe_static(distance, physics: PhysicsConfig, device=None):
    """De-normalize ``distance``, keeping host scalars as Python floats.

    A host-scalar distance stays a Python float, which routes the propagator
    to its constant-transfer-function kernel. The fp32 roundings of the
    tensor expression ``((d + c) * k) * 1e-3`` are mirrored with numpy, so
    the static and per-sample paths give bit-identical distances.
    """
    s = static_scalar(distance)
    if s is not None:
        d32 = np.float32(s)
        c32 = np.float32(physics.distance_normalize_constant)
        k32 = np.float32(physics.distance_normalize)
        return float(((d32 + c32) * k32) * np.float32(1e-3))
    return physics.to_metres(torch.as_tensor(distance, dtype=torch.float32, device=device))


def holo_forward(
    amplitude: torch.Tensor,
    phase: torch.Tensor,
    distance,
    physics: PhysicsConfig,
    *,
    return_field: bool = False,
    complex_number: bool = False,
    unwrap: bool = False,
    asm_backend: str | None = None,
) -> torch.Tensor | Tuple[torch.Tensor, torch.Tensor]:
    """Diffraction field of the object ``A exp(i phi)`` at ``distance``.

    * default: the intensity hologram ``|H|^2`` (fp32);
    * ``return_field=True``: ``(|H|, angle(H))``, the phase optionally
      unwrapped;
    * ``complex_number=True``: the complex field.
    """
    amplitude = torch.as_tensor(amplitude, dtype=torch.float32)
    d_m = _to_metres_maybe_static(distance, physics, device=amplitude.device)
    phase = torch.as_tensor(phase, dtype=torch.float32, device=amplitude.device)
    phase = phase * float(np.float32(physics.phase_normalize))

    obj = torch.complex(amplitude * torch.cos(phase), amplitude * torch.sin(phase))
    field = propagate(
        obj,
        d_m,
        wavelength=physics.wavelength,
        pixel_size=physics.pixel_size,
        pad=True,
        pad_factor=physics.pad_factor,
        band_limit=physics.band_limit,
        backend=asm_backend,
    )

    if return_field:
        amp_prop = torch.abs(field)
        ph_prop = torch.angle(field)
        if unwrap:
            ph_prop = unwrap_phase(ph_prop)
        return amp_prop, ph_prop
    if complex_number:
        return field
    return torch.abs(field) ** 2


def back_prop(
    holo: torch.Tensor,
    distance,
    physics: PhysicsConfig,
    *,
    amplitude_normalize: float = 1.0,
    output: str = "amp_pha",
) -> torch.Tensor:
    """Back-propagate an intensity hologram without padding: sqrt -> ASM by
    ``distance`` -> a 2-channel stack of (amplitude, phase) or (real, imag)
    on axis -3."""
    holo = torch.as_tensor(holo, dtype=torch.float32)
    d_m = physics.to_metres(torch.as_tensor(distance, dtype=torch.float32, device=holo.device))
    field = propagate(
        torch.sqrt(holo).to(torch.complex64),
        d_m,
        wavelength=physics.wavelength,
        pixel_size=physics.pixel_size,
        pad=False,
    )
    field = field * amplitude_normalize
    if output == "amp_pha":
        a, b = torch.abs(field), torch.angle(field)
    else:
        a, b = field.real, field.imag
    return torch.cat([a.float(), b.float()], dim=-3)
