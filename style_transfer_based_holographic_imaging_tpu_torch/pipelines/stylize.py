"""Pure AdaIN style transfer between two holograms (port of the JAX
package's ``pipelines/stylize.py``).

Encode the content and the style hologram, AdaIN-mix their relu4_1
features, interpolate by ``alpha`` and decode: a hologram re-rendered in
another hologram's style, without the physics refocus (a look at what the
style space has learned). fp32, eager, on the net's device.
"""

from __future__ import annotations

from typing import Dict

import torch

from style_transfer_based_holographic_imaging_tpu_torch.ops.stats import adain

__all__ = ["stylize"]


@torch.inference_mode()
def stylize(net, content: torch.Tensor, style: torch.Tensor, alpha: float = 1.0) -> Dict[str, torch.Tensor]:
    """Re-render ``content`` in the style of ``style``.

    Args:
      net: a ``StyleTransferNet``, on the device to run on.
      content, style: NCHW ``(B, 1, H, W)`` sqrt-intensity holograms.
      alpha: style strength in [0, 1] (the net's ``alpha``).

    Returns:
      ``amp`` and ``phase``, ``(B, 1, H, W)``: the decoded style-plane field.
    """
    dev = next(net.parameters()).device
    f_c = net.encode(torch.as_tensor(content, dtype=torch.float32, device=dev))
    f_s = net.encode(torch.as_tensor(style, dtype=torch.float32, device=dev))
    t = adain(f_c, f_s)
    t = alpha * t + (1.0 - alpha) * f_c
    out = net.decoder(t)
    return {"amp": out[:, 0:1], "phase": out[:, 1:2]}
