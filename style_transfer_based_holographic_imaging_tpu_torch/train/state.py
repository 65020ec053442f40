"""Train state and optimizer (port of the JAX package's ``train/state.py``).

The optimizer is written out as optax computes it, not as ``torch.optim``
does, so that a JAX run and a port run take the same steps:

* ``clip_by_global_norm``: ``g`` if ``norm < max`` else ``g / norm * max``,
  the norm over the trainable gradients only (``clip_grad_norm_`` would add
  1e-6 and multiply by a clamped coefficient);
* Adam (b1 0.9, b2 0.999, eps 1e-8): ``mu = (1-b1) g + b1 mu``,
  ``nu = (1-b2) g^2 + b2 nu``, bias corrections ``1 - b^(count+1)`` in fp32,
  ``mu_hat / (sqrt(nu_hat) + eps)`` scaled by ``-lr(count)``, ``count`` the
  step before its increment;
* the schedules ``invtime`` ``lr / (1 + decay count)`` and ``cosine``
  (optax's ``cosine_decay_schedule`` to 2 % over ``iterations``);
* ``freeze_encoder``: optax's ``multi_transform`` with ``set_to_zero`` on the
  encoder, so the encoder has no moments and gets no update;
* EMA ``d e + (1 - d) p`` of the updated parameters;
* the discriminator's Adam at the constant ``lr``.

Parameters are flat state dicts (the port's module names), as in
``interop.convert_params``; the updates run in place with ``torch._foreach``
ops, as the JAX step donates its state. Checkpoints are ``iter_<n>``
directories holding one ``state.pt`` (``torch.save`` of CPU tensors), the
whole state whatever the partition it was trained under: a run on a mesh
gathers its shards first (``parallel.gather_state``), and a snapshot
restores into any partition (``restore_checkpoint``, then
``parallel.shard_state``).
"""

from __future__ import annotations

import dataclasses
import os
import sys
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from style_transfer_based_holographic_imaging_tpu_torch.config import TrainConfig

__all__ = [
    "AdamState",
    "TrainState",
    "Adam",
    "make_optimizer",
    "make_disc_optimizer",
    "create_train_state",
    "apply_gradients",
    "apply_disc_gradients",
    "update_ema",
    "save_checkpoint",
    "restore_checkpoint",
    "latest_snapshot",
    "load_train_params",
]

_B1, _B2, _EPS = 0.9, 0.999, 1e-8
_F32 = np.float32
Params = Dict[str, torch.Tensor]


@dataclass
class AdamState:
    """optax's ``ScaleByAdamState``: the count and the moments of the
    optimized names."""

    count: int
    mu: Params
    nu: Params


@dataclass
class TrainState:
    step: int
    params: Params
    opt_state: AdamState
    disc_params: Optional[Params] = None
    disc_opt_state: Optional[AdamState] = None
    ema_params: Optional[Params] = None  # None when EMA is off


class Adam:
    """optax's ``chain(clip_by_global_norm, adam(schedule))``, optionally
    under ``multi_transform`` with the ``encoder.`` names set to zero."""

    def __init__(self, lr, *, clip_norm: float = 0.0, lr_decay: float = 0.0,
                 schedule: str = "constant", iterations: int = 1, freeze_encoder: bool = False):
        if schedule not in ("constant", "invtime", "cosine"):
            raise ValueError(f"unknown lr schedule {schedule!r}")
        self.lr, self.clip_norm, self.lr_decay = lr, clip_norm, lr_decay
        self.schedule, self.iterations = schedule, max(iterations, 1)
        self.freeze_encoder = freeze_encoder

    def trainable(self, name: str) -> bool:
        return not (self.freeze_encoder and name.startswith("encoder."))

    def step_size(self, count: int) -> float:
        """``lr(count)`` in fp32, as optax's schedule gives it."""
        if self.schedule == "invtime":
            return float(_F32(self.lr) / (_F32(1.0) + _F32(self.lr_decay) * _F32(count)))
        if self.schedule == "cosine":
            c = _F32(min(count, self.iterations))
            cos = _F32(0.5) * (_F32(1.0) + np.cos(_F32(np.pi) * c / _F32(self.iterations)))
            return float(_F32(self.lr) * (_F32(1.0 - 0.02) * cos + _F32(0.02)))
        return float(_F32(self.lr))

    def init(self, params: Params) -> AdamState:
        names = [k for k in params if self.trainable(k)]
        return AdamState(0, {k: torch.zeros_like(params[k]) for k in names},
                         {k: torch.zeros_like(params[k]) for k in names})

    def update(self, grads: Params, state: AdamState, params: Params, *,
               sum_sq: Optional[Callable[[Dict[str, torch.Tensor]], torch.Tensor]] = None) -> None:
        """One step in place: ``params`` and ``state`` take the new values.
        ``grads`` holds the optimized names of ``state.mu``. ``sum_sq``, given
        ``{name: sum of the squares of its gradient}``, returns the squared
        global norm the clip takes; the default adds them up. A step on
        sharded gradients passes the sum over their shards
        (``train.loop.TrainStep``): each element counted once, the same
        total on every rank, so that every rank takes one decision."""
        names = list(state.mu)
        g = [grads[k] for k in names]
        if self.clip_norm:
            squares = {k: torch.sum(t * t) for k, t in zip(names, g)}
            norm = torch.sqrt(sum(squares.values()) if sum_sq is None else sum_sq(squares))
            if not bool(norm < self.clip_norm):
                g = torch._foreach_mul(torch._foreach_div(g, norm), self.clip_norm)
        mu = [state.mu[k] for k in names]
        nu = [state.nu[k] for k in names]
        torch._foreach_mul_(mu, _B1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - _B1))
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, 1.0 - _B2)
        torch._foreach_mul_(nu, _B2)
        torch._foreach_add_(nu, g2)
        n = _F32(state.count + 1)
        bc1 = float(_F32(1.0) - _F32(_B1) ** n)
        bc2 = float(_F32(1.0) - _F32(_B2) ** n)
        den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(den, _EPS)
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        torch._foreach_mul_(upd, -self.step_size(state.count))
        torch._foreach_add_([params[k] for k in names], upd)
        state.count += 1


def make_optimizer(cfg: TrainConfig) -> Adam:
    """The generator's optimizer (the JAX ``make_optimizer``)."""
    return Adam(cfg.lr, clip_norm=cfg.grad_clip_norm, lr_decay=cfg.lr_decay,
                schedule="cosine" if cfg.lr_schedule == "cosine" else "invtime",
                iterations=cfg.iterations, freeze_encoder=cfg.freeze_encoder)


def make_disc_optimizer(cfg: TrainConfig) -> Adam:
    """The discriminator's: Adam at the constant ``lr`` (``optax.adam(lr)``)."""
    return Adam(cfg.lr)


def _clone(params: Params) -> Params:
    return {k: v.detach().clone() for k, v in params.items()}


def create_train_state(params: Params, cfg: TrainConfig, *, disc_params: Optional[Params] = None,
                       device: str | torch.device = "cuda") -> TrainState:
    """A fresh state on ``device`` (the card unless asked for the CPU); the
    EMA is a copy of the params, not an alias."""
    params = {k: v.detach().to(device, torch.float32).clone() for k, v in params.items()}
    disc = None
    if disc_params is not None:
        disc = {k: v.detach().to(device, torch.float32).clone() for k, v in disc_params.items()}
    return TrainState(
        step=0,
        params=params,
        opt_state=make_optimizer(cfg).init(params),
        disc_params=disc,
        disc_opt_state=make_disc_optimizer(cfg).init(disc) if disc is not None else None,
        ema_params=_clone(params) if cfg.ema_decay else None,
    )


def apply_gradients(state: TrainState, grads: Params, tx: Adam, ema_decay: float = 0.0) -> None:
    """The generator's step in place (the JAX ``TrainState.apply_gradients``):
    the optimizer, the step count, then the EMA of the updated params."""
    tx.update(grads, state.opt_state, state.params)
    state.step += 1
    update_ema(state, ema_decay)


def update_ema(state: TrainState, ema_decay: float) -> None:
    """``ema = d ema + (1 - d) params`` in place, where the state keeps one."""
    if state.ema_params is not None:
        names = list(state.params)
        ema = [state.ema_params[k] for k in names]
        torch._foreach_mul_(ema, ema_decay)
        torch._foreach_add_(ema, torch._foreach_mul([state.params[k] for k in names], 1.0 - ema_decay))


def apply_disc_gradients(state: TrainState, grads: Params, disc_tx: Adam) -> None:
    """The discriminator's step in place."""
    disc_tx.update(grads, state.disc_opt_state, state.disc_params)


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, AdamState):
        return {"count": tree.count, "mu": _cpu(tree.mu), "nu": _cpu(tree.nu)}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def save_checkpoint(state: TrainState, ckpt_dir: str, step: Optional[int] = None) -> str:
    """``<ckpt_dir>/iter_<step>/state.pt``: step, params, optimizer state and,
    where the run has them, the discriminator's and the EMA. Written to a
    temporary file first and renamed, so an interrupted save leaves no
    partial snapshot."""
    step = state.step if step is None else step
    path = os.path.abspath(os.path.join(ckpt_dir, f"iter_{step}"))
    os.makedirs(path, exist_ok=True)
    tree = {f.name: _cpu(getattr(state, f.name)) for f in dataclasses.fields(state)
            if getattr(state, f.name) is not None}
    tmp = os.path.join(path, "state.pt.tmp")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(path, "state.pt"))
    return path


def _params_to(tree: Params, device) -> Params:
    return {k: v.to(device) for k, v in tree.items()}


def _adam_to(tree, device) -> AdamState:
    return AdamState(int(tree["count"]), _params_to(tree["mu"], device), _params_to(tree["nu"], device))


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """The snapshot at ``path`` in ``state``'s structure and devices. A group
    the snapshot lacks (discriminator, EMA) restarts: the discriminator from
    ``state``'s, the EMA from the restored params; a group ``state`` lacks
    is ignored. Both print a notice."""
    tree = torch.load(os.path.join(path, "state.pt"), map_location="cpu", weights_only=True)
    missing = [g for g in ("disc_params", "ema_params") if getattr(state, g) is not None and g not in tree]
    extra = [g for g in ("disc_params", "ema_params") if getattr(state, g) is None and g in tree]
    if missing or extra:
        print(f"note: snapshot {path}"
              + (f" lacks {'+'.join(missing)} (restart)" if missing else "")
              + (f" carries {'+'.join(extra)} the run does not use (ignored)" if extra else ""),
              file=sys.stderr)
    dev = next(iter(state.params.values())).device
    out = TrainState(step=int(tree["step"]), params=_params_to(tree["params"], dev),
                     opt_state=_adam_to(tree["opt_state"], dev),
                     disc_params=state.disc_params, disc_opt_state=state.disc_opt_state)
    if state.disc_params is not None and "disc_params" in tree:
        out.disc_params = _params_to(tree["disc_params"], dev)
        out.disc_opt_state = _adam_to(tree["disc_opt_state"], dev)
    if state.ema_params is not None:
        out.ema_params = (_params_to(tree["ema_params"], dev) if "ema_params" in tree
                          else _clone(out.params))
    return out


def latest_snapshot(ckpt_dir: str) -> Optional[str]:
    """The newest complete ``iter_<n>`` snapshot in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    iters = sorted(
        (d for d in os.listdir(ckpt_dir)
         if d.startswith("iter_") and d.split("_", 1)[1].isdigit()
         and os.path.isfile(os.path.join(ckpt_dir, d, "state.pt"))),
        key=lambda s: int(s.split("_")[1]),
    )
    return os.path.join(ckpt_dir, iters[-1]) if iters else None


def load_train_params(path: str, *, ema: bool = True) -> Params:
    """The generator's state dict of a snapshot, for
    ``StyleTransferNet.from_state_dict``: the EMA where the run kept one and
    ``ema`` is set, else the params."""
    tree = torch.load(os.path.join(path, "state.pt"), map_location="cpu", weights_only=True)
    return dict(tree["ema_params"] if ema and "ema_params" in tree else tree["params"])
