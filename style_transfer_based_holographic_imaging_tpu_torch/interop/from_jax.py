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
moments), the discriminator's params and Adam state, and the EMA. A
mixed-precision run (``ModelConfig.dtype`` bfloat16) keeps its params, Adam
moments and EMA in fp32 in both packages: its state converts the same way,
and resumes under the port's bf16 ``TrainStep``.

``convert_pipeline_state`` splits the JAX package's pipeline state (the
``(S, Pmax)`` packed parameters and Adam moments of ``parallel/pp.py``'s
fine-tune and training steps) into one state a stage, in the port's layout,
so that a JAX pipeline run resumes in the port's pipeline; its inverse
``pipeline_state_to_jax`` packs the stages' states back, bit for bit.

``convert_ablation_variables`` carries the variables of the JAX package's
ablation modules (``models/ablations.py``: ``params`` and, with batch norm,
``batch_stats``) into the state dict of the port's counterpart: a norm's
``scale`` becomes its ``weight``, the running ``mean``/``var`` the buffers
``running_mean``/``running_var``, ECA's ``(k, 1, 1)`` kernel a ``Conv1d``
weight ``(1, 1, k)``; every other leaf converts as ``convert_params``
converts it (a ``CBR(sampling="up")`` kernel HWIO -> OIHW, unflipped, the
layout the port's up-conv correlates with).

``load_release_weights`` reads a release's state dict back from the numpy
file that ``scripts/port_golden_eval.py --export-npz`` writes (one fp32
array per state-dict key). The orbax release itself needs no such copy:
``orbax_read.restore`` reads it without orbax, and
``train.load_release_params`` converts it.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

__all__ = ["convert_params", "convert_train_state", "convert_pipeline_state", "pipeline_state_to_jax",
           "convert_ablation_variables", "load_release_weights", "load_style_vector"]


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


def _jax_leaf(path: Tuple[str, ...], value: np.ndarray) -> np.ndarray:
    """The inverse of ``_convert_leaf``'s layout change: a port tensor of
    the JAX leaf ``path`` back in the JAX package's layout."""
    *modules, leaf = path
    if leaf == "kernel" and value.ndim == 4 and not modules[-1].startswith("up"):
        return np.transpose(value, (2, 3, 1, 0))     # OIHW -> HWIO
    if leaf == "kernel" and value.ndim == 2:
        return value.T
    return value


def convert_pipeline_state(packed, m, v, t, *, image_size: int, width: float, n_stages: int,
                           with_phase_decoder: bool = False):
    """A JAX pipeline state ``(packed, m, v, t)`` (``make_pipeline_finetune_fn``'s
    ``state0`` and steps, the first four fields of ``make_pipeline_train_fn``'s;
    numpy leaves) -> one ``(params, m, v, t)`` a stage, the port's
    pipeline state of that stage's rank: fp32 tensors on the CPU by state
    dict name, and ``t`` a 0-dim fp32 tensor. The stages are read by the
    offsets the JAX package packs them with (``parallel.pp.stage_leaves``)."""
    from style_transfer_based_holographic_imaging_tpu_torch.parallel.pp import stage_leaves

    arrays = [np.asarray(a, dtype=np.float32) for a in (packed, m, v)]
    if any(a.ndim != 2 or a.shape[0] != n_stages for a in arrays):
        raise ValueError(f"a {n_stages}-stage state needs (S, Pmax) arrays, got "
                         f"{[a.shape for a in arrays]}")
    out = []
    for s, leaves in enumerate(stage_leaves(image_size, width, n_stages, with_phase_decoder)):
        trees = []
        for a in arrays:
            tree, pos = {}, 0
            for path, shape in leaves:
                n = int(np.prod(shape))
                name, val = _convert_leaf(path, a[s, pos:pos + n].reshape(shape))
                tree[name] = torch.tensor(np.ascontiguousarray(val))
                pos += n
            trees.append(tree)
        out.append((*trees, torch.tensor(np.float32(np.asarray(t)))))
    return out


def pipeline_state_to_jax(states, *, image_size: int, width: float, n_stages: int,
                          with_phase_decoder: bool = False):
    """The inverse of ``convert_pipeline_state``: the stages' ``(params, m,
    v, t)`` (in stage order) -> the JAX package's ``(packed, m, v, t)`` numpy
    arrays, each stage's leaves at their offsets, zero beyond them."""
    from style_transfer_based_holographic_imaging_tpu_torch.parallel.pp import stage_leaves

    layout = stage_leaves(image_size, width, n_stages, with_phase_decoder)
    if len(states) != n_stages:
        raise ValueError(f"{len(states)} stage states for {n_stages} stages")
    sizes = [max(sum(int(np.prod(shape)) for _, shape in leaves), 1) for leaves in layout]
    packed = [np.zeros((n_stages, max(sizes)), np.float32) for _ in range(3)]
    for s, (leaves, state) in enumerate(zip(layout, states)):
        for arr, tree in zip(packed, state[:3]):
            pos = 0
            for path, shape in leaves:
                name, _ = _convert_leaf(path, np.zeros(shape, np.float32))
                val = _jax_leaf(path, tree[name].detach().cpu().numpy())
                arr[s, pos:pos + val.size] = val.reshape(-1)
                pos += val.size
    return (*packed, np.float32(np.asarray(states[0][3].detach().cpu())))


def convert_params(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX params pytree (numpy leaves) -> the port's ``StyleTransferNet`` state dict."""
    inner = tree.get("params", tree)
    state = {}
    for path, value in _flatten(inner):
        name, arr = _convert_leaf(path, value)
        state[name] = torch.tensor(np.ascontiguousarray(arr), dtype=torch.float32)
    return state


_BATCH_STATS = {"mean": "running_mean", "var": "running_var"}


def convert_ablation_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX variables of an ablation module (``params`` and, where
    present, ``batch_stats``; numpy leaves) -> the port's state dict, which
    the port's module of ``models/ablations.py`` loads with ``strict=True``."""
    state = {}
    for path, value in _flatten(variables["params"]):
        *modules, leaf = path
        if leaf == "scale":
            name, arr = ".".join(modules + ["weight"]), value
        elif leaf == "kernel" and value.ndim == 3:
            name, arr = ".".join(modules + ["weight"]), np.transpose(value, (2, 1, 0))  # (k,1,1) -> (1,1,k)
        else:
            name, arr = _convert_leaf(path, value)
        state[name] = torch.tensor(np.ascontiguousarray(arr), dtype=torch.float32)
    for path, value in _flatten(variables.get("batch_stats", {})):
        *modules, leaf = path
        state[".".join(modules + [_BATCH_STATS[leaf]])] = torch.tensor(value, dtype=torch.float32)
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
