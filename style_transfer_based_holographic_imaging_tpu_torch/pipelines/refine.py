"""Physics-consistent refinement of retrieved fields (port of the JAX
package's ``pipelines/refine.py``).

The retrieved object field is polished against its measured hologram:

    minimize_{A, phi, (d)}   || |ASM(A e^{i phi}, d)| - sqrt(I_meas) ||^2
                             + tv_weight * TV(phi) / B

from the network's refocused output and its predicted distance, by Adam
written out as the JAX package writes it (its ``run_adam``): b1 0.9, b2 0.999,
eps 1e-8, the bias corrections in fp32 and a cosine step-size decay to 10 %.
The JAX package runs the steps as one ``lax.scan``; here they are a plain
loop of eager steps.

Each step differentiates ``ops.holo.holo_forward`` with a per-sample
distance. On a CUDA tensor with the ``auto`` or ``cuda`` backend its forward
is the ``asm_dynamic`` kernel and its backward the adjoint of the
``torch.fft`` composition (the op ``holostyle::asm_dynamic``): ``steps + 1`` launches a batch, and with
``refine_distance`` ``max(steps // 2, 10)`` more.

``refine_retrieval`` is the served form (the server's and the stream's
``refine_steps``): amplitude and phase refined jointly from a retrieval
step's outputs, with autograd on whatever grad mode the calling thread is in.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from style_transfer_based_holographic_imaging_tpu_torch.config import PhysicsConfig
from style_transfer_based_holographic_imaging_tpu_torch.ops.holo import holo_forward
from style_transfer_based_holographic_imaging_tpu_torch.train.losses import tv_loss

__all__ = ["physics_refine", "refine_retrieval"]

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def physics_refine(
    amp0,
    phase0,
    distance,
    measured_amp,
    physics: PhysicsConfig,
    *,
    steps: int = 60,
    lr: float = 0.05,
    tv_weight: float = 5e-3,
    refine_distance: bool = False,
    optimize_amp: bool = True,
    asm_backend: Optional[str] = None,
    device: str | torch.device = "cuda",
) -> Dict[str, torch.Tensor]:
    """Polish an object-plane field against its measured hologram.

    Args:
      amp0, phase0: the retrieved object field ``(B, 1, H, W)``, the
        refocused amplitude and phase (radians).
      distance: ``(B, 1, 1, 1)`` propagation distance in network units.
      measured_amp: sqrt of the measured intensity hologram ``(B, 1, H, W)``.
      steps: Adam iterations of the joint stage.
      tv_weight: weight of the phase's TV term, per sample.
      refine_distance: also optimise the distance; a first stage of
        ``max(steps // 2, 10)`` steps then moves the distance alone at
        ``lr * 0.1`` (else the per-pixel field absorbs the defocus).
      optimize_amp: optimise the amplitude too. For a pure-phase domain with
        known illumination pass False and give ``amp0`` that amplitude.
      asm_backend: the propagator's backend (``ops.asm.propagate``).
      device: where the steps run.

    Returns a dict of fp32 tensors on ``device``: the refined ``amp``,
    ``phase`` (radians) and ``distance``, and the per-sample RMS data
    residual ``residual`` ``(B,)``.
    """
    f32 = dict(dtype=torch.float32, device=torch.device(device))
    # holo_forward multiplies its phase by physics.phase_normalize, so the
    # variable is the phase in network units, scaled back out at the end.
    pn = np.float32(physics.phase_normalize)
    params = {
        "amp": torch.as_tensor(amp0, **f32).clone(),
        "phase": torch.as_tensor(phase0, **f32) / torch.tensor(pn, **f32),
        "d": torch.as_tensor(distance, **f32).clone(),
    }
    meas = torch.as_tensor(measured_amp, **f32)
    batch = max(int(params["phase"].shape[0]), 1)

    def data_residual(p):
        synth = holo_forward(p["amp"], p["phase"], p["d"], physics, asm_backend=asm_backend)
        return torch.sqrt(torch.clamp(synth, min=0.0)) - meas

    def loss_fn(p):
        r = data_residual(p)
        loss = torch.mean(r * r)
        if tv_weight:
            # tv_loss sums over the batch: normalise so that the balance of
            # TV and data does not depend on the batch size.
            loss = loss + tv_weight * tv_loss(p["phase"]) / batch
        return loss

    def run_adam(params, keys, n_steps, key_lr):
        """``n_steps`` of Adam over ``keys``, the step size decayed by
        ``0.1 + 0.45 (1 + cos(pi i / n))``."""
        m = {k: torch.zeros_like(params[k]) for k in keys}
        v = {k: torch.zeros_like(params[k]) for k in keys}
        for i in range(n_steps):
            p = {k: t.detach().requires_grad_(k in keys) for k, t in params.items()}
            grads = torch.autograd.grad(loss_fn(p), [p[k] for k in keys])
            # The schedule's scalars in fp32, as the JAX package's scan
            # computes them from its fp32 step counter.
            t = np.float32(i + 1)
            decay = np.float32(0.1) + np.float32(0.45) * (
                np.float32(1.0) + np.cos(np.float32(math.pi) * np.float32(i) / np.float32(max(n_steps, 1)))
            )
            bc1 = np.float32(1.0) - np.float32(_B1) ** t
            bc2 = np.float32(1.0) - np.float32(_B2) ** t
            with torch.no_grad():
                for k, g in zip(keys, grads):
                    m[k] = _B1 * m[k] + (1 - _B1) * g
                    v[k] = _B2 * v[k] + (1 - _B2) * g * g
                    mhat = m[k] / float(bc1)
                    vhat = v[k] / float(bc2)
                    step = float(np.float32(decay) * np.float32(key_lr[k]))
                    params[k] = params[k] - step * mhat / (torch.sqrt(vhat) + _EPS)
        return params

    keys = (("amp",) if optimize_amp else ()) + ("phase",) + (("d",) if refine_distance else ())
    if refine_distance:
        params = run_adam(params, ("d",), max(steps // 2, 10), {"d": lr * 0.1})
    params = run_adam(params, keys, steps, {"amp": lr, "phase": lr, "d": lr * 0.02})

    with torch.no_grad():
        r = data_residual(params)
        return {
            "amp": params["amp"],
            "phase": params["phase"] * torch.tensor(pn, **f32),
            "distance": params["d"],
            "residual": torch.sqrt(torch.mean(r * r, dim=(1, 2, 3))),
        }


def refine_retrieval(
    out: Dict[str, torch.Tensor],
    holo: torch.Tensor,
    physics: PhysicsConfig,
    *,
    steps: int,
    device: str | torch.device = "cuda",
) -> Dict[str, torch.Tensor]:
    """``out`` (a ``retrieval_step`` result) with ``amp_foc`` and ``ph_foc``
    refined jointly against the intensity holograms ``holo`` (``steps`` Adam
    steps from ``distance_pred``), as the JAX package's server and stream do.

    The refine differentiates, so it leaves any inference mode and enables
    autograd here: an HTTP handler thread or a caller under
    ``torch.inference_mode`` would otherwise run it without gradients.
    """
    with torch.inference_mode(False), torch.enable_grad():
        refined = physics_refine(
            out["amp_foc"],
            out["ph_foc"],
            out["distance_pred"],
            torch.sqrt(torch.as_tensor(holo, dtype=torch.float32, device=device)),
            physics,
            steps=steps,
            device=device,
        )
    return dict(out, amp_foc=refined["amp"], ph_foc=refined["phase"])
