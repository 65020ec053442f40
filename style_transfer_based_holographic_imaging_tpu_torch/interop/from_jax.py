"""Carry JAX parameter trees across to the port.

``convert_params`` takes the flax parameter tree of the JAX package's
``StyleTransferNet`` as nested dicts of numpy arrays (for example the result
of an orbax restore of ``checkpoints/release``, with or without its outer
``'params'`` level) and returns a state dict that the port's
``StyleTransferNet`` loads with ``strict=True``:

* Conv kernels go HWIO -> OIHW (the 1x1 stem included);
* Dense kernels go ``(in, out)`` -> ``(out, in)``;
* ConvTranspose kernels (``up*``) are already in torch's
  ``(C_in, C_out, 2, 2)`` layout and stay as they are;
* biases stay as they are.

A ``decoder_ph`` subtree, when present, converts like ``decoder``; build the
net with ``has_phase_decoder(tree)``.

``load_release_weights`` reads a release's state dict back from the numpy
file that ``scripts/port_golden_eval.py --export-npz`` writes (one fp32
array per state-dict key), where orbax cannot run: on the card machine,
and in ``cli serve``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

__all__ = ["convert_params", "load_release_weights", "load_style_vector"]


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, np.asarray(value)


def _convert_leaf(path: Tuple[str, ...], value: np.ndarray) -> Tuple[str, np.ndarray]:
    *modules, leaf = path
    if leaf == "bias":
        return ".".join(modules + ["bias"]), value
    if leaf != "kernel":
        raise KeyError(f"unexpected parameter {'/'.join(path)}")
    layer = modules[-1]
    if value.ndim == 4 and layer.startswith("up"):
        out = value                                   # (C_in, C_out, 2, 2)
    elif value.ndim == 4:
        out = np.transpose(value, (3, 2, 0, 1))       # HWIO -> OIHW
    elif value.ndim == 2:
        out = value.T                                 # (in, out) -> (out, in)
    else:
        raise ValueError(f"kernel {'/'.join(path)} has unexpected shape {value.shape}")
    return ".".join(modules + ["weight"]), out


def convert_params(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX params pytree (numpy leaves) -> the port's ``StyleTransferNet`` state dict."""
    inner = tree.get("params", tree)
    state = {}
    for path, value in _flatten(inner):
        name, arr = _convert_leaf(path, value)
        state[name] = torch.tensor(np.ascontiguousarray(arr), dtype=torch.float32)
    return state


def load_release_weights(path: str) -> Dict[str, torch.Tensor]:
    """The port's state dict of a release from its ``torch_weights.npz``. Build
    the net with ``StyleTransferNet.from_state_dict(state, width)``, the width
    from the release's ``config.json``."""
    with np.load(path) as z:
        state = {k: torch.from_numpy(np.asarray(z[k])) for k in z.files}
    bad = [k for k, v in state.items() if v.dtype != torch.float32]
    if bad:
        raise ValueError(f"{path}: arrays not float32: {bad}")
    return state


def load_style_vector(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """``(mean, std)`` of a ``style_vector.npz`` (keys ``mean``/``std``, each
    ``(1, 1, 1, C)`` in the JAX package's NHWC layout)."""
    with np.load(path) as z:
        return np.asarray(z["mean"], np.float32), np.asarray(z["std"], np.float32)
