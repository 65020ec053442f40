"""Space-to-depth ("packed") form of the 128^2 head and tail layers (port of
the JAX ``kernels/packed_conv.py``), NCHW, plain torch.

It is no kernel: the JAX module reaches no ``pallas_call``. On the TPU it
was a measured dead end (the JAX ``models/quant.py`` and "Traps" in
``docs/PERFORMANCE.md``), and nothing in the JAX package or in the port
calls it; it is kept so that every JAX module has its counterpart.

The layers are rewritten exactly on a 2x2 packing:

* an image ``(B, C, H, W)`` becomes ``(B, 4C, H/2, W/2)``, channel
  ``(p * 2 + q) * C + c`` holding the pixel of phase ``(p, q)``;
* ``ReflectionPad2d(1)`` + a VALID 3x3 conv becomes a VALID 2x2 conv over
  the *shifted* packing ``z[r] = x[r - 1]`` (``pack_image``, or
  ``repad_packed`` of the last layer's packed output): output phase ``d``
  reads packed cells ``{i, i + 1}``, so the packed kernel is
  ``K'[(d, e, o), (p, q, i), A, B] = k[o, i, 2A + p - d, 2B + q - e]``
  (zero outside the 3x3 taps);
* ``ConvTranspose2d(k=2, s=2)`` is a matmul in packed space, and a 2x2 max
  pool is the max over the four phase groups.

The int8 form goes through ``models.quant.int8_conv_valid`` on the packed
operands, as the JAX module goes through its own: the packed kernel's
per-output-channel scales are the 3x3 kernel's, and the absmax of a packed
tensor is the unpacked one's, so the same calibrated scales apply.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from style_transfer_based_holographic_imaging_tpu_torch.models.layers import conv_in_dtype

__all__ = [
    "pack_image",
    "pack_kernel",
    "pack_bias",
    "repad_packed",
    "unpack_image",
    "packed_pool",
    "packed_deconv",
    "packed_reflect_conv",
]


def pack_kernel(k: torch.Tensor) -> torch.Tensor:
    """``(O, I, 3, 3)`` conv kernel -> ``(4O, 4I, 2, 2)`` packed kernel, the
    channels in ``(phase, channel)`` order as ``pack_image`` packs them."""
    if k.shape[2] != 3 or k.shape[3] != 3:
        raise ValueError(f"pack_kernel expects 3x3, got {tuple(k.shape[2:])}")
    o_ch, i_ch = k.shape[0], k.shape[1]
    kz = F.pad(k, (1, 1, 1, 1))  # rows and columns -1 and 3 read zero
    out = k.new_empty(2, 2, o_ch, 2, 2, i_ch, 2, 2)  # (d, e, o, p, q, i, A, B)
    for d in range(2):
        for e in range(2):
            for p in range(2):
                for q in range(2):
                    for a in range(2):
                        for b in range(2):
                            out[d, e, :, p, q, :, a, b] = kz[:, :, 2 * a + p - d + 1, 2 * b + q - e + 1]
    return out.reshape(4 * o_ch, 4 * i_ch, 2, 2)


def pack_bias(bias: torch.Tensor) -> torch.Tensor:
    """``(O,)`` -> ``(4O,)``, tiled over the four output phases."""
    return bias.repeat(4)


def pack_image(x: torch.Tensor) -> torch.Tensor:
    """``(B, C, H, W)`` -> the shifted packing ``(B, 4C, H/2 + 1, W/2 + 1)``
    with the reflection border in it: ``Z[(p, q, c), i, j] = x_pad[c, 2i + p,
    2j + q]`` of the reflect-padded ``x``. H and W must be even."""
    xp = F.pad(x, (1, 1, 1, 1), mode="reflect")
    b, c, hp, wp = xp.shape
    z = xp.reshape(b, c, hp // 2, 2, wp // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return z.reshape(b, 4 * c, hp // 2, wp // 2)


def repad_packed(y: torch.Tensor) -> torch.Tensor:
    """Unshifted packing ``(B, 4C, h, w)`` -> the shifted packing with the
    reflection border ``(B, 4C, h + 1, w + 1)``, the input of
    ``packed_reflect_conv``: phase ``p`` of Z is phase ``1 - p`` of Y moved
    by one packed row, its reflected row a copy of the group's own edge row
    (a one-sided ``replicate`` pad per phase group)."""
    b, c4, h, w = y.shape
    g = y.reshape(b, 2, 2, c4 // 4, h, w)
    groups = []
    for p in range(2):
        rows = (1, 0) if p == 0 else (0, 1)
        for q in range(2):
            cols = (1, 0) if q == 0 else (0, 1)
            groups.append(F.pad(g[:, 1 - p, 1 - q], cols + rows, mode="replicate"))
    return torch.cat(groups, dim=1)


def unpack_image(y: torch.Tensor) -> torch.Tensor:
    """Unshifted packing ``(B, 4C, h, w)`` -> ``(B, C, 2h, 2w)``."""
    b, c4, h, w = y.shape
    c = c4 // 4
    return y.reshape(b, 2, 2, c, h, w).permute(0, 3, 4, 1, 5, 2).reshape(b, c, 2 * h, 2 * w)


def packed_pool(y: torch.Tensor) -> torch.Tensor:
    """``MaxPool2d(2, 2)`` of the unpacked field: the max over the four phase
    groups, ``(B, 4C, h, w)`` -> ``(B, C, h, w)``."""
    b, c4, h, w = y.shape
    return y.reshape(b, 4, c4 // 4, h, w).amax(dim=1)


def packed_deconv(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``ConvTranspose2d(C_in, C_out, 2, stride=2)`` (``kernel`` in torch's
    ``(C_in, C_out, 2, 2)`` layout, ``models.layers.ConvTranspose2x2``) as a
    packed matmul: ``(B, C_in, h, w)`` -> the unshifted packing ``(B,
    4 C_out, h, w)``, ``y[(d, e, o)] = sum_c x[c] W[c, o, d, e]``, in ``dt``."""
    c_in, c_out = kernel.shape[0], kernel.shape[1]
    m = kernel.to(dt).permute(0, 2, 3, 1).reshape(c_in, 4 * c_out)
    return torch.einsum("bchw,cf->bfhw", x.to(dt), m) + pack_bias(bias).to(dt).view(1, -1, 1, 1)


def packed_reflect_conv(
    z: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor,
    *,
    dt: torch.dtype,
    act_max: Optional[torch.Tensor] = None,
    relu: bool = True,
) -> torch.Tensor:
    """One ``ReflectionPad2d(1)`` + 3x3 conv on a shifted packing ``z`` (``(B,
    4C, h + 1, w + 1)`` from ``pack_image`` or ``repad_packed``), with the
    layer's own ``(O, I, 3, 3)`` kernel and ``(O,)`` bias: the unshifted
    packing ``(B, 4O, h, w)``. ``act_max`` (a calibrated absmax) takes the
    int8 form (``models.quant.int8_conv_valid``), else the conv runs in
    ``dt`` (``models.layers.conv_in_dtype``)."""
    kp = pack_kernel(kernel.float())
    bp = pack_bias(bias)
    if act_max is None:
        y = conv_in_dtype(F.conv2d, z, kp, bp, dt)
        return torch.relu(y) if relu else y
    from style_transfer_based_holographic_imaging_tpu_torch.models.quant import int8_conv_valid

    return int8_conv_valid(z, kp, bp, dt=dt, act_max=act_max, relu=relu, reflect_pad=False)
