"""The reference's torch checkpoints in the port (port of the JAX
``interop/torch_weights.py``).

The reference publishes ``state_dict`` files keyed by ``nn.Sequential``
indices:

* ``vgg_normalised.pth``: the VGG-19 encoder; its RGB 1x1 stem is collapsed
  to one input channel by a sum over the input-channel axis, as the
  reference's ``test_field_retrieval_mnist.py`` does before it loads it;
* ``decoder_iter_*.pth.tar`` (and ``decoder_ph_iter_*.pth.tar``): the
  amplitude/phase decoder;
* ``distance_g_iter_*.pth.tar``: the distance MLP;
* ``style_vector.pt``: the ``(2, C, 1, 1)`` AdaIN statistics, means then
  stds.

The port's layers keep torch's layouts (Conv2d ``(O, I, kh, kw)``,
ConvTranspose2d ``(I, O, kh, kw)``, Linear ``(out, in)``), so a reference
checkpoint is a rename of its keys into the port's ``StyleTransferNet``
state dict: the ``convert_*_kernel`` helpers keep the layout (the JAX
package's transpose to flax's), and ``convert_*_state_dict`` return the
state dicts of the port's ``VggEncoder``, ``AmpPhaseDecoder`` and
``DistanceMLP``. VGG keys past conv4_1 are ignored, as in the JAX package.

``load_style_vector`` here reads the reference's ``.pt``; the package
exports it as ``load_style_vector_pt`` beside the ``.npz`` reader of
``interop/from_jax.py``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "load_torch_tensor",
    "torch_to_numpy",
    "convert_conv_kernel",
    "convert_conv_transpose_kernel",
    "convert_linear_kernel",
    "convert_vgg_state_dict",
    "convert_decoder_state_dict",
    "convert_distance_state_dict",
    "load_reference_checkpoint",
    "load_style_vector",
    "save_style_vector_pt",
]


def load_torch_tensor(path: str):
    """A ``.pt``/``.pth`` file as (possibly nested) numpy arrays."""
    return torch_to_numpy(torch.load(path, map_location="cpu", weights_only=False))


def torch_to_numpy(obj):
    """Tensors to numpy arrays, through dicts, lists and tuples."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: torch_to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(torch_to_numpy(v) for v in obj)
    return obj


def _fp32(w: np.ndarray) -> torch.Tensor:
    return torch.tensor(np.ascontiguousarray(w), dtype=torch.float32)


def convert_conv_kernel(w: np.ndarray) -> torch.Tensor:
    """Conv2d ``(O, I, kh, kw)``, the port's layout: kept, as fp32."""
    return _fp32(w)


def convert_conv_transpose_kernel(w: np.ndarray) -> torch.Tensor:
    """ConvTranspose2d ``(I, O, kh, kw)``, the port's ``ConvTranspose2x2``
    layout: kept, as fp32."""
    return _fp32(w)


def convert_linear_kernel(w: np.ndarray) -> torch.Tensor:
    """Linear ``(out, in)``, the port's layout: kept, as fp32."""
    return _fp32(w)


# Sequential indices of the Conv2d layers of the reference's `net.vgg` -> the
# port's VggEncoder names.
_VGG_INDEX_TO_NAME = {
    0: "stem",
    2: "conv1_1",
    5: "conv1_2",
    9: "conv2_1",
    12: "conv2_2",
    16: "conv3_1",
    19: "conv3_2",
    22: "conv3_3",
    25: "conv3_4",
    29: "conv4_1",
}

# Sequential indices of the Conv2d / ConvTranspose2d layers of the
# reference's `net.decoder` -> the port's AmpPhaseDecoder names.
_DECODER_INDEX_TO_NAME = {
    1: ("conv0", False),
    4: ("conv1", False),
    6: ("up0", True),
    9: ("conv2", False),
    12: ("conv3", False),
    15: ("conv4", False),
    18: ("conv5", False),
    20: ("up1", True),
    23: ("conv6", False),
    26: ("conv7", False),
    28: ("up2", True),
    31: ("conv8", False),
    34: ("conv9", False),
    37: ("conv10", False),
}


def convert_vgg_state_dict(state: Dict[str, np.ndarray], *, collapse_rgb_stem: bool = True
                           ) -> Dict[str, torch.Tensor]:
    """The reference's VGG state dict -> the port's ``VggEncoder`` state
    dict. ``collapse_rgb_stem`` sums an RGB stem over its input channels
    (``state_dict['0.weight'].sum(dim=1, keepdim=True)``, the reference's
    own load), so that it takes grayscale holograms. A checkpoint cut
    before conv4_1 stops early."""
    state = {k: np.asarray(v) for k, v in state.items()}
    if collapse_rgb_stem and state["0.weight"].shape[1] != 1:
        state["0.weight"] = state["0.weight"].sum(axis=1, keepdims=True)
    out: Dict[str, torch.Tensor] = {}
    for idx, name in _VGG_INDEX_TO_NAME.items():
        if f"{idx}.weight" not in state:
            continue
        out[f"{name}.weight"] = convert_conv_kernel(state[f"{idx}.weight"])
        out[f"{name}.bias"] = _fp32(state[f"{idx}.bias"])
    return out


def convert_decoder_state_dict(state: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The reference's decoder state dict -> the port's ``AmpPhaseDecoder``
    state dict."""
    out: Dict[str, torch.Tensor] = {}
    for idx, (name, is_transpose) in _DECODER_INDEX_TO_NAME.items():
        convert = convert_conv_transpose_kernel if is_transpose else convert_conv_kernel
        out[f"{name}.weight"] = convert(np.asarray(state[f"{idx}.weight"]))
        out[f"{name}.bias"] = _fp32(np.asarray(state[f"{idx}.bias"]))
    return out


def convert_distance_state_dict(state: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """The reference's ``Distance_G`` state dict -> the port's
    ``DistanceMLP`` state dict."""
    out: Dict[str, torch.Tensor] = {}
    for name in ("l1", "l2", "l3", "out"):
        out[f"{name}.weight"] = convert_linear_kernel(np.asarray(state[f"{name}.weight"]))
        out[f"{name}.bias"] = _fp32(np.asarray(state[f"{name}.bias"]))
    return out


def load_reference_checkpoint(vgg: str, decoder: str, distance: str, *, image_size: int = 128,
                              decoder_ph: Optional[str] = None, device=None):
    """The reference's torch files -> the port's ``StyleTransferNet`` (width
    1.0) state dict, or, with ``device``, the net itself on that device in
    eval mode (``"cpu"`` for the CPU).

    ``decoder_ph`` adds the reference's phase decoder
    (``decoder_ph_iter_80000.pth.tar``, the ``AmpPhaseDecoder`` layout); the
    net then takes its phase from it (``models.net.has_phase_decoder``). The
    reference loads that file but takes the phase from the main decoder's
    channel 1, so leave it out to reproduce the reference's outputs.

    Leaves the files do not cover (a VGG cut before conv4_1) keep the
    port's ``init_net_params`` draw from ``torch.Generator`` seed 0: the
    same distributions as the JAX package's ``init_net_params(key(0))``,
    other values. A shape that differs from the net's raises and names the
    layer. ``image_size`` is the JAX function's: the port's net takes any
    size, so it changes nothing.
    """
    from style_transfer_based_holographic_imaging_tpu_torch.models.net import (
        StyleTransferNet,
        init_net_params,
    )

    del image_size
    with_ph = decoder_ph is not None
    with torch.device("meta"):  # the shapes alone, nothing drawn
        shapes = {k: v.shape for k, v in StyleTransferNet(with_phase_decoder=with_ph).state_dict().items()}
    converted = {
        "encoder": convert_vgg_state_dict(load_torch_tensor(vgg)),
        "decoder": convert_decoder_state_dict(load_torch_tensor(decoder)),
        "distance_g": convert_distance_state_dict(load_torch_tensor(distance)),
    }
    if with_ph:
        converted["decoder_ph"] = convert_decoder_state_dict(load_torch_tensor(decoder_ph))
    state = {}
    for module, tree in converted.items():
        for leaf, value in tree.items():
            name = f"{module}.{leaf}"
            if value.shape != shapes[name]:
                raise ValueError(f"{name}: torch {tuple(value.shape)} != model {tuple(shapes[name])}")
            state[name] = value
    if len(state) < len(shapes):
        init = init_net_params(torch.Generator().manual_seed(0), width=1.0, with_phase_decoder=with_ph)
        state = {name: state.get(name, init[name]) for name in shapes}
    if device is None:
        return state
    return StyleTransferNet.from_state_dict(state, width=1.0).to(device)


def load_style_vector(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's ``style_vector.pt`` ``(2, C, 1, 1)`` -> (mean, std),
    each ``(1, 1, 1, C)`` float32, the layout of the ``.npz`` style vectors."""
    sv = np.asarray(load_torch_tensor(path), dtype=np.float32)
    if sv.shape[0] != 2:
        raise ValueError(f"{path}: expected (2, C, 1, 1), got {sv.shape}")
    c = sv.shape[1]
    return sv[0].reshape(1, 1, 1, c), sv[1].reshape(1, 1, 1, c)


def save_style_vector_pt(mean: np.ndarray, std: np.ndarray, path: str) -> None:
    """A style vector in the reference's layout: a float32 tensor ``(2, C, 1,
    1)``, row 0 the means, row 1 the stds."""
    c = int(np.asarray(mean).size)
    sv = np.stack([np.asarray(mean, np.float32).reshape(c, 1, 1),
                   np.asarray(std, np.float32).reshape(c, 1, 1)])
    torch.save(torch.from_numpy(sv), path)
