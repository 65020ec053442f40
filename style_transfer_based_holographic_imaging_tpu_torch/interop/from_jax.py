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
net with ``has_phase_decoder(tree)``. The ``PatchDiscriminator``'s tree
converts the same way (its convs are HWIO kernels).

``convert_train_state`` carries a JAX ``TrainState`` across (its fields as
numpy arrays, the optax states as their namedtuples or as nested dicts), so
that a JAX run resumes in the port: the step, the params, the optax Adam
moments and count (under ``clip_by_global_norm``, and under
``multi_transform`` with a frozen encoder, whose masked leaves carry no
moments), the discriminator's params and Adam state, and the EMA.

``load_release_weights`` reads a release's state dict back from the numpy
file that ``scripts/port_golden_eval.py --export-npz`` writes (one fp32
array per state-dict key), where orbax cannot run: on the card machine,
and in ``cli serve``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

__all__ = ["convert_params", "convert_train_state", "load_release_weights", "load_style_vector"]


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        elif value is None or (isinstance(value, tuple) and not value):
            continue                                  # optax's MaskedNode: no moment
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


def _adam_state(node):
    """``(count, mu, nu)`` of the first optax ``ScaleByAdamState`` in an
    optimizer state (namedtuples, tuples or dicts)."""
    if isinstance(node, Mapping):
        if "mu" in node and "nu" in node:
            return node["count"], node["mu"], node["nu"]
        children = node.values()
    elif hasattr(node, "mu") and hasattr(node, "nu"):
        return node.count, node.mu, node.nu
    elif isinstance(node, (tuple, list)):
        children = node
    else:
        return None
    for child in children:
        found = _adam_state(child)
        if found is not None:
            return found
    return None


def _convert_adam(opt_state, device):
    from style_transfer_based_holographic_imaging_tpu_torch.train.state import AdamState

    found = _adam_state(opt_state)
    if found is None:
        raise ValueError("no Adam state (mu, nu, count) in the optimizer state")
    count, mu, nu = found
    to = lambda t: {k: v.to(device) for k, v in convert_params(t).items()}  # noqa: E731
    return AdamState(int(np.asarray(count)), to(mu), to(nu))


def convert_train_state(tree: Mapping, *, device: str | torch.device = "cuda"):
    """A JAX ``TrainState`` (``step``, ``params``, ``opt_state`` and, where
    the run had them, ``disc_params``, ``disc_opt_state``, ``ema_params``;
    numpy leaves, e.g. ``jax.device_get`` of the state's fields) -> the
    port's ``train.TrainState`` on ``device`` (the card unless asked for the
    CPU, as ``train()``)."""
    from style_transfer_based_holographic_imaging_tpu_torch.train.state import TrainState

    def params(t):
        return {k: v.to(device) for k, v in convert_params(t).items()}

    get = tree.get if isinstance(tree, Mapping) else lambda k: getattr(tree, k, None)
    state = TrainState(step=int(np.asarray(get("step"))), params=params(get("params")),
                       opt_state=_convert_adam(get("opt_state"), device))
    if get("disc_params") is not None:
        state.disc_params = params(get("disc_params"))
        state.disc_opt_state = _convert_adam(get("disc_opt_state"), device)
    if get("ema_params") is not None:
        state.ema_params = params(get("ema_params"))
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
