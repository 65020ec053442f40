"""Training loop (port of the JAX package's ``train/loop.py``): the generator
loss, the train step and ``train()``.

  L = w_c L_content + w_s L_style + w_phy L_phy + w_d (L_dist_style + L_dist_content)
    + w_sup L_field_supervised + w_perc L_perceptual + w_tv TV(phi_t) + w_adv L_adv

The network runs in the compute dtype of ``ModelConfig.dtype``: fp32, or
bf16 for mixed-precision training (the JAX package's ``dtype=bfloat16``):
bf16 convs, the distance head in bf16, and fp32 params, Adam moments, EMA,
discriminator and every loss, its outputs cast up at the loss boundary as
the JAX package casts them. ``TrainConfig.remat`` recomputes the network
forward in the backward (``torch.utils.checkpoint``, the JAX package's
``jax.checkpoint``); the distance head's dropout generator is rewound for
the recompute, so both passes draw one mask. With
``TrainConfig.tensorboard_dir`` the logged scalars are also mirrored to a
TensorBoard event directory (``utils/tb.py``).

The stop-gradients of the JAX package are ``.detach()``;
its jitted, donated step is an eager step that updates the state in place.
The step's parts are separate methods of ``TrainStep`` (the generator's
gradients, the optimizer and EMA, the discriminator's step), so that they
can be timed alone. On the card every convolution is cuDNN's (TF32 off);
the kernels on the path are the synthesis's ``asm_dynamic`` (two launches
a batch, ``data/synth.py``) and, with the ``cuda`` reflect backend, the
border ring with its gradient (the op ``kernels/reflect_border.border_lines``).

Over a device mesh (``parallel/``) the same step runs in one process a
mesh position, each on its shards of the state and its rows of the batch,
with the collectives the JAX package leaves to GSPMD written out
(``TrainStep``'s ``mesh`` and ``state_shardings``, ``train``'s ``mesh`` and
``partition``); a step on N ranks is the one-process step on the whole
batch.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from style_transfer_based_holographic_imaging_tpu_torch.config import (
    ExperimentConfig,
    PhysicsConfig,
    TrainConfig,
    compute_dtype_name,
)
from style_transfer_based_holographic_imaging_tpu_torch.data.synth import (
    InfiniteHologramSampler,
    sklearn_digit_bank,
    stream_generator,
)
from style_transfer_based_holographic_imaging_tpu_torch.models.discriminator import PatchDiscriminator
from style_transfer_based_holographic_imaging_tpu_torch.models.distance import RowDropout
from style_transfer_based_holographic_imaging_tpu_torch.models.layers import at_least_fp32
from style_transfer_based_holographic_imaging_tpu_torch.models.net import (
    StyleTransferNet,
    init_net_params,
    init_params,
)
from style_transfer_based_holographic_imaging_tpu_torch.parallel.mesh import (
    all_gather,
    all_reduce,
    local_rows,
    reduce_scatter,
    replicated,
)
from style_transfer_based_holographic_imaging_tpu_torch.parallel.tp import column_parallel
from style_transfer_based_holographic_imaging_tpu_torch.parallel.zero import (
    gather_state,
    partition_state_shardings,
    shard_state,
)
from style_transfer_based_holographic_imaging_tpu_torch.train.losses import (
    distance_loss,
    lsgan_d_loss,
    lsgan_g_loss,
    physics_cycle_loss,
    style_plane_target,
    tv_loss,
)
from style_transfer_based_holographic_imaging_tpu_torch.train.state import (
    Params,
    TrainState,
    apply_disc_gradients,
    apply_gradients,
    create_train_state,
    make_disc_optimizer,
    make_optimizer,
    save_checkpoint,
    update_ema,
)
from style_transfer_based_holographic_imaging_tpu_torch.utils.tb import make_writer

__all__ = ["generator_loss_fn", "TrainStep", "train", "compute_dtype"]


def compute_dtype(name: str) -> torch.dtype:
    """``ModelConfig.dtype`` -> the network's compute dtype (the JAX
    package's ``_compute_dtype``): bf16 is mixed-precision training."""
    return torch.bfloat16 if compute_dtype_name(name) == "bfloat16" else torch.float32


def generator_loss_fn(
    params: Params,
    batch: Dict[str, torch.Tensor],
    *,
    net: StyleTransferNet,
    physics: PhysicsConfig,
    cfg: TrainConfig,
    disc_params: Optional[Params] = None,
    disc: Optional[PatchDiscriminator] = None,
    dropout: Optional[torch.Generator] = None,
    dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The generator-side loss of ``net`` at ``params`` on a batch of NCHW
    sqrt-holograms, and its terms (``aux``; ``g_t`` for the discriminator,
    in the compute ``dtype``). ``dropout`` is the distance head's train-mode
    generator (``cfg.use_dropout``). Every loss is fp32."""
    gen = dropout if cfg.use_dropout else None
    kw = {"dropout": gen, "dtype": dtype}
    if cfg.remat:
        # The recompute must draw the dropout masks the forward drew: the
        # checkpoint restores the global RNGs, not this generator, so it
        # is rewound to its state at the forward on each pass.
        start = gen.get_state() if gen is not None else None

        def apply_net(p, content, style):
            if gen is not None:
                gen.set_state(start)
            return functional_call(net, p, (content, style, 1.0), kw)

        out = checkpoint(apply_net, params, batch["content_holo"], batch["style_holo"],
                         use_reentrant=False)
    else:
        out = functional_call(net, params, (batch["content_holo"], batch["style_holo"], 1.0), kw)
    # Up to fp32 at the loss boundary: every term below sums in fp32.
    amp_t, ph_t = at_least_fp32(out["g_t"]), at_least_fp32(out["g_t_phase"])
    d_c_pred, d_s_pred = at_least_fp32(out["d_content"]), at_least_fp32(out["d_style"])

    loss = cfg.content_weight * out["loss_content"]
    loss = loss + cfg.style_weight * out["loss_style"]
    aux = {"loss_content": out["loss_content"], "loss_style": out["loss_style"]}

    if cfg.physics_weight:
        # ph_t is in normalized phase units; holo_forward applies
        # phase_normalize itself.
        l_phy = physics_cycle_loss(amp_t, ph_t, d_c_pred.reshape(-1, 1, 1, 1),
                                   batch["distance_style"], batch["content_holo"], physics)
        loss = loss + cfg.physics_weight * l_phy
        aux["loss_physics"] = l_phy

    if cfg.distance_weight:
        l_d = (distance_loss(d_s_pred, batch["distance_style"])
               + distance_loss(d_c_pred, batch["distance_content"]))
        loss = loss + cfg.distance_weight * l_d
        aux["loss_distance"] = l_d

    if (cfg.supervised_weight or cfg.perceptual_weight) and "phase_content" in batch:
        # The true style-plane field of the content object (synthetic data).
        gt_amp, gt_ph = style_plane_target(batch["amplitude"], batch["phase_content"],
                                           batch["distance_style"], physics)
        gt_ph = gt_ph / physics.phase_normalize     # the decoder's normalized units
        if cfg.supervised_weight:
            l_sup = torch.mean((amp_t - gt_amp) ** 2) + torch.mean((ph_t - gt_ph) ** 2)
            loss = loss + cfg.supervised_weight * l_sup
            aux["loss_supervised"] = l_sup
        if cfg.perceptual_weight:
            # The encoder's taps with its params detached: gradients reach
            # only the predicted phase, never the features themselves.
            frozen = {k[len("encoder."):]: v.detach() for k, v in params.items()
                      if k.startswith("encoder.")}

            def feats(x):
                return functional_call(net.encoder, frozen, (x,), {"all_taps": True, "dtype": dtype})

            l_perc = torch.zeros((), dtype=torch.float32, device=ph_t.device)
            for f_p, f_g in zip(feats(ph_t), feats(gt_ph.to(ph_t.dtype))):
                l_perc = l_perc + torch.mean((at_least_fp32(f_p) - at_least_fp32(f_g)) ** 2)
            l_perc = l_perc / 4.0
            loss = loss + cfg.perceptual_weight * l_perc
            aux["loss_perceptual"] = l_perc

    if cfg.tv_weight:
        l_tv = tv_loss(ph_t)
        loss = loss + cfg.tv_weight * l_tv
        aux["loss_tv"] = l_tv

    if cfg.adv_weight and disc is not None and disc_params is not None:
        fake_logits, _ = functional_call(disc, disc_params, (amp_t,))
        l_adv = lsgan_g_loss(fake_logits)
        loss = loss + cfg.adv_weight * l_adv
        aux["loss_adv"] = l_adv

    aux["loss_total"] = loss
    aux["g_t"] = out["g_t"]
    return loss, aux


def _grads(loss: torch.Tensor, wrt) -> list:
    """d loss / d wrt, zeros for a tensor the loss does not reach (the
    discriminator's ``head_cls``), as ``jax.grad`` gives them."""
    grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g for t, g in zip(wrt, grads)]


def _detached(aux: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in aux.items()}


class _MeshPlan:
    """A train step's mesh and plan (``parallel.partition_state_shardings``;
    ``None``: every leaf whole): the rank's place and groups, each leaf's
    layout, and the collectives of a step. The rank holds the state's
    shards (``parallel.shard_state``) and its share of the batch
    (``parallel.local_rows``)."""

    def __init__(self, mesh, shardings, cfg: TrainConfig):
        if cfg.dp_axis not in mesh.shape:
            raise ValueError(
                f"mesh axes {tuple(mesh.axis_names)} lack the data-parallel axis "
                f"{cfg.dp_axis!r} (TrainConfig.dp_axis) — training always shards the batch "
                f"over it; for TP-only training use a (data=1, model=N) mesh")
        self.mesh, self.shardings, self.axis = mesh, shardings, cfg.dp_axis
        self.groups = mesh.groups()
        self.coords = mesh.coords(dist.get_rank())
        self.data = self.groups[cfg.dp_axis]
        self.n_data = mesh.shape[cfg.dp_axis]
        self._whole = replicated(mesh)

    def layout(self, group: str, name: str):
        """The sharding of leaf ``name`` of a state field (``params``,
        ``disc_params``, ``ema_params``; ``opt_state`` and
        ``disc_opt_state`` for the moments)."""
        if self.shardings is None:
            return self._whole
        node = getattr(self.shardings, group)
        return (node.mu if group in ("opt_state", "disc_opt_state") else node)[name]

    def whole_over_data(self, params: Params, group: str) -> Params:
        """``params`` with each leaf split over ``data`` all-gathered (FSDP's
        gather at the step's start); a split over ``model`` stays."""
        out = {}
        for k, v in params.items():
            d = self.layout(group, k).split_dims().get(self.axis)
            out[k] = v if d is None else all_gather(v, d, self.data)
        return out

    def reduce_grads(self, grads: Params, group: str) -> Params:
        """The gradients summed over ``data``, each into the layout of its
        moments: reduce-scattered where they are split over ``data``, else
        all-reduced (together, in one flat buffer)."""
        out, whole = {}, []
        for k, g in grads.items():
            d = self.layout(group, k).split_dims().get(self.axis)
            if d is None:
                whole.append(k)
            else:
                out[k] = reduce_scatter(g, d, self.data)
        if whole:
            flat = all_reduce(torch.cat([grads[k].reshape(-1) for k in whole]), self.data)
            for k, part in zip(whole, flat.split([grads[k].numel() for k in whole])):
                out[k] = part.view_as(grads[k])
        return {k: out[k] for k in grads}

    def _owned(self, sharding) -> bool:
        """Whether this rank counts its shard of a leaf in a sum over the
        world: one rank among those holding the same shard."""
        split = sharding.split_dims()
        return all(i == 0 for a, i in self.coords.items() if a not in split)

    def sum_sq(self, group: str):
        """The clip's squared global norm of sharded gradients: each shard
        counted once over the world (a leaf whole on every rank, once)."""

        def total(squares: Dict[str, torch.Tensor]) -> torch.Tensor:
            owned = [v for k, v in squares.items() if self._owned(self.layout(group, k))]
            s = sum(owned) if owned else torch.zeros((), device=next(iter(squares.values())).device)
            return all_reduce(s.clone(), None)

        return total

    def apply(self, params: Params, opt, grads: Params, tx, params_group: str, opt_group: str) -> None:
        """Adam in place on the moments' shards: where the moments are split
        over an axis the params are not (ZeRO-1), the update runs on the
        rank's slice of the params and one all-gather over that axis
        rebuilds them."""
        views, rebuild = {}, {}
        for k in opt.mu:
            p_split = self.layout(params_group, k).split_dims()
            m_split = self.layout(opt_group, k).split_dims()
            if any(m_split.get(a) != d for a, d in p_split.items()):
                raise ValueError(f"{k}: the params are split where their moments are not")
            v = params[k]
            extra = [(a, d) for a, d in m_split.items() if a not in p_split]
            for a, d in extra:
                n = v.shape[d] // self.mesh.shape[a]
                v = v.narrow(d, self.coords[a] * n, n)
            views[k] = v
            if extra:
                rebuild[k] = extra
        tx.update(grads, opt, views, sum_sq=self.sum_sq(opt_group))
        for k, extra in rebuild.items():
            v = views[k]
            for a, d in reversed(extra):
                v = all_gather(v, d, self.groups[a])
            params[k].copy_(v)

    def reduce_aux(self, aux: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The rank's shares of the logged losses summed over ``data``: the
        global batch's values."""
        keys = [k for k in aux if k != "g_t"]
        total = all_reduce(torch.stack([aux[k].float() for k in keys]), self.data)
        out = {k: total[i] for i, k in enumerate(keys)}
        if "g_t" in aux:
            out["g_t"] = aux["g_t"]
        return out


class TrainStep:
    """One optimizer step (the JAX ``make_train_step``), in place on the
    state: the generator's gradients (averaged over ``grad_accum``
    micro-batches), its update and EMA, then the discriminator's update from
    its params before the step and the detached ``g_t`` of the forward.
    ``dtype`` is the network's compute dtype (``compute_dtype``); the
    discriminator and the optimizer stay fp32.

    With a ``mesh`` the step runs in each rank of the mesh's world on the
    rank's shards of the state and its share of the batch, and equals the
    one-process step on the whole batch. ``state_shardings`` is the plan
    (``parallel.partition_state_shardings``; ``None``: plain data
    parallelism, the state whole on every rank). The losses are means over
    the batch but for ``tv_loss``, a sum: each rank differentiates its share
    of the global loss (the means scaled by its share of the batch, the sum
    not), the gradients and the logged losses are summed over ``data``, the
    clip takes the norm over the shards, and the distance head's dropout
    masks are the one-process batch's rows (``models.distance.RowDropout``).
    Layers whose weights the plan splits over ``model`` become
    column-parallel (``parallel.tp.column_parallel``)."""

    def __init__(self, net: StyleTransferNet, physics: PhysicsConfig, cfg: TrainConfig, *,
                 disc: Optional[PatchDiscriminator] = None, dtype: torch.dtype = torch.float32,
                 mesh=None, state_shardings=None):
        if cfg.grad_accum > 1 and cfg.adv_weight:
            raise ValueError("grad_accum > 1 is not supported with the adversarial term "
                             "(the discriminator update would see stale generator outputs)")
        self.net, self.physics, self.cfg, self.disc, self.dtype = net, physics, cfg, disc, dtype
        self.tx = make_optimizer(cfg)
        self.disc_tx = make_disc_optimizer(cfg)
        self.plan = None
        if mesh is None:
            if state_shardings is not None:
                raise ValueError("state_shardings requires a mesh")
        else:
            self.plan = _MeshPlan(mesh, state_shardings, cfg)
            if state_shardings is not None:
                column_parallel(net, state_shardings.params)
                if disc is not None and state_shardings.disc_params is not None:
                    column_parallel(disc, state_shardings.disc_params)

    def _objective(self, loss: torch.Tensor, aux: Dict[str, torch.Tensor]):
        """(what a rank differentiates, its aux): on a mesh the rank's share
        of the global loss, the means scaled by its share of the batch and
        ``tv_loss``'s sum not, and aux likewise."""
        if self.plan is None:
            return loss, _detached(aux)
        share = 1.0 / self.plan.n_data
        obj = share * loss
        if "loss_tv" in aux:
            obj = obj + (1.0 - share) * self.cfg.tv_weight * aux["loss_tv"]
        out = {k: v.detach() if k in ("g_t", "loss_tv") else share * v.detach() for k, v in aux.items()}
        out["loss_total"] = obj.detach()
        return obj, out

    def _dropout(self, dropout, b_micro: int):
        """On a mesh, the rank's rows of the one-process micro-batch's masks."""
        if dropout is None or self.plan is None:
            return dropout
        d = self.plan.coords[self.plan.axis]
        return RowDropout(dropout, b_micro * self.plan.n_data, slice(d * b_micro, (d + 1) * b_micro))

    def generator_grads(self, state: TrainState, batch, dropout=None):
        """(gradients of the optimized names, aux with ``g_t``); on a mesh in
        the layout of the moments, and the global batch's aux."""
        plan = self.plan
        src, disc_params = state.params, state.disc_params
        if plan is not None:
            src = plan.whole_over_data(src, "params")
            if disc_params is not None:
                disc_params = plan.whole_over_data(disc_params, "disc_params")
        params = {k: v.detach().requires_grad_(self.tx.trainable(k)) for k, v in src.items()}
        wrt = [k for k in params if params[k].requires_grad]
        k = self.cfg.grad_accum
        b = batch["content_holo"].shape[0]
        kw = dict(net=self.net, physics=self.physics, cfg=self.cfg, disc_params=disc_params,
                  disc=self.disc, dropout=self._dropout(dropout, b // max(k, 1)), dtype=self.dtype)
        if k <= 1:
            loss, aux = generator_loss_fn(params, batch, **kw)
            obj, aux = self._objective(loss, aux)
            grads = dict(zip(wrt, _grads(obj, [params[n] for n in wrt])))
        else:
            if b % k:
                raise ValueError(f"batch size {b} must divide by grad_accum={k}")
            total, total_aux = None, None
            for i in range(k):
                micro = {n: v[i * (b // k):(i + 1) * (b // k)] for n, v in batch.items()}
                loss, aux = generator_loss_fn(params, micro, **kw)
                aux.pop("g_t")
                obj, aux = self._objective(loss, aux)
                g = _grads(obj, [params[n] for n in wrt])
                if total is None:
                    total, total_aux = list(g), aux
                else:
                    total = [t + u for t, u in zip(total, g)]
                    total_aux = {n: total_aux[n] + aux[n] for n in total_aux}
            inv_k = 1.0 / k
            grads = {n: t * inv_k for n, t in zip(wrt, total)}
            aux = {n: a * inv_k for n, a in total_aux.items()}
        if plan is not None:
            grads = plan.reduce_grads(grads, "opt_state")
            aux = plan.reduce_aux(aux)
        return grads, aux

    def apply(self, state: TrainState, grads: Params) -> None:
        if self.plan is None:
            apply_gradients(state, grads, self.tx, self.cfg.ema_decay)
            return
        self.plan.apply(state.params, state.opt_state, grads, self.tx, "params", "opt_state")
        state.step += 1
        update_ema(state, self.cfg.ema_decay)

    def disc_step(self, state: TrainState, fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
        """The discriminator's LSGAN step on ``real`` and ``fake`` (in fp32,
        whatever the generator's dtype); its loss (on a mesh: each rank's
        own ``fake`` and ``real``, the global batch's loss)."""
        plan = self.plan
        src = state.disc_params if plan is None else plan.whole_over_data(state.disc_params, "disc_params")
        dp = {k: v.detach().requires_grad_() for k, v in src.items()}
        real_logits, _ = functional_call(self.disc, dp, (at_least_fp32(real),))
        fake_logits, _ = functional_call(self.disc, dp, (at_least_fp32(fake),))
        d_loss = lsgan_d_loss(real_logits, fake_logits)
        if plan is None:
            grads = _grads(d_loss, list(dp.values()))
            apply_disc_gradients(state, dict(zip(dp, grads)), self.disc_tx)
            return d_loss.detach()
        obj = d_loss / plan.n_data
        grads = plan.reduce_grads(dict(zip(dp, _grads(obj, list(dp.values())))), "disc_opt_state")
        plan.apply(state.disc_params, state.disc_opt_state, grads, self.disc_tx, "disc_params",
                   "disc_opt_state")
        return all_reduce(obj.detach(), plan.data)

    def __call__(self, state: TrainState, batch, dropout=None):
        grads, aux = self.generator_grads(state, batch, dropout)
        self.apply(state, grads)
        fake = aux.pop("g_t", None)
        if self.cfg.adv_weight and self.disc is not None and state.disc_params is not None:
            aux["loss_disc"] = self.disc_step(state, fake, batch["style_holo"])
        return state, aux


def train(
    config: ExperimentConfig,
    *,
    bank: Optional[np.ndarray] = None,
    sampler=None,
    state: Optional[TrainState] = None,
    iterations: Optional[int] = None,
    device: str | torch.device = "cuda",
    log_fn: Callable[[str], None] = print,
    mesh=None,
    partition: str = "dp",
) -> TrainState:
    """Run (or continue) training on ``device`` (the card unless asked for the
    CPU); returns the final state, which the step updated in place.

    The stream is ``InfiniteHologramSampler`` over ``bank`` (default:
    ``sklearn_digit_bank``), aligned to the state's step. ``sampler``, a
    ``data.mat_sampler.MeasuredHologramSampler`` over a measured tree, takes
    its place, its ``iteration`` aligned to the state's step.
    Measured batches carry no ground truth, so the supervised term stays
    out of the loss: pass ``supervised_weight=0`` to say so.
    The network computes in ``ModelConfig.dtype`` (``compute_dtype``).
    Logs every ``log_every`` steps, to ``log_fn``, as one JSON line in
    ``<checkpoint_dir>/train_metrics.jsonl`` and, with ``tensorboard_dir``,
    as scalars of an event file; saves ``iter_<n>`` snapshots
    every ``checkpoint_every`` steps. ``iterations`` defaults to the rest of
    the schedule (``cfg.iterations`` minus the state's step).

    With a ``mesh`` (``parallel.make_mesh``) this runs in every rank of the
    mesh's world (``parallel.launch``), each on its mesh device (``device``
    is not read), and ``partition`` picks the state's layout
    (``parallel.PARTITION_PLANS``): ``dp`` keeps it whole on every rank,
    ``zero1``/``fsdp`` split the moments / the whole state over ``data``,
    ``tp``/``tp_fsdp`` add channel tensor parallelism over ``model``. The
    given or fresh state is whole; each rank keeps its shards. Every rank
    draws the global batch on the host and renders its rows alone
    (``parallel.local_rows``). Rank 0 alone logs and writes the metrics,
    the event file and the snapshots (the state gathered whole); every rank
    returns the whole final state.
    """
    cfg, physics = config.train, config.physics
    if partition != "dp" and mesh is None:
        raise ValueError(f"partition {partition!r} requires a mesh")
    rank, plan, rows = 0, None, None
    if mesh is not None:
        if cfg.dp_axis not in mesh.shape:
            raise ValueError(
                f"mesh axes {tuple(mesh.axis_names)} lack the data-parallel axis {cfg.dp_axis!r} "
                f"(TrainConfig.dp_axis) — training always shards the batch over it; for "
                f"TP-only training use a (data=1, model=N) mesh")
        if config.data.batch_size % mesh.shape[cfg.dp_axis]:
            raise ValueError(
                f"batch_size {config.data.batch_size} must be divisible by the "
                f"'{cfg.dp_axis}' mesh axis size ({mesh.shape[cfg.dp_axis]})")
        mesh.groups()
        rank = dist.get_rank()
        device = mesh.device_list[rank]
        rows = local_rows(config.data.batch_size, mesh, rank, cfg.dp_axis, max(cfg.grad_accum, 1))
    dtype = compute_dtype(config.model.dtype)
    device = torch.device(device)
    net = StyleTransferNet(width=config.model.width,
                           with_phase_decoder=config.model.with_phase_decoder).to(device)
    # the JAX package's discriminator: flax defaults at the data's image size
    make_disc = lambda: PatchDiscriminator(image_size=config.data.image_size).to(device)  # noqa: E731
    disc = make_disc() if cfg.adv_weight else None
    if state is None:
        params = init_net_params(torch.Generator().manual_seed(config.data.seed),
                                 width=config.model.width,
                                 with_phase_decoder=config.model.with_phase_decoder)
        disc_params = None
        if disc is not None:
            disc_params = init_params(disc, torch.Generator().manual_seed(config.data.seed + 1))
        state = create_train_state(params, cfg, disc_params=disc_params, device=device)
    elif disc is not None and state.disc_params is None:
        # Resuming an adversarial run from a snapshot without a discriminator:
        # attach a fresh one rather than silently dropping L_adv.
        log_fn("note: adv_weight > 0 but the resumed state has no discriminator; "
               "initializing a fresh one")
        dp = init_params(disc, torch.Generator().manual_seed(config.data.seed + 1))
        state.disc_params = {k: v.to(device) for k, v in dp.items()}
        state.disc_opt_state = make_disc_optimizer(cfg).init(state.disc_params)
    if state.disc_params is not None and disc is None:
        disc = make_disc()
    if mesh is not None:
        plan = partition_state_shardings(partition, state, mesh)
        state = shard_state(state, plan, rank)

    if sampler is None:
        sampler = InfiniteHologramSampler(
            sklearn_digit_bank() if bank is None else bank, config.data, physics,
            return_gt=bool(cfg.supervised_weight), start_iteration=state.step, device=device,
            rows=rows)
    else:
        sampler.iteration = state.step
    step_fn = TrainStep(net, physics, cfg, disc=disc, dtype=dtype, mesh=mesh, state_shardings=plan)
    n_iter = max(cfg.iterations - state.step, 0) if iterations is None else iterations

    def whole(st):
        return st if plan is None else gather_state(st, plan)

    start = state.step
    tb = make_writer(cfg.tensorboard_dir) if rank == 0 else None
    t0 = time.time()
    try:
        for i, batch in zip(range(n_iter), sampler):
            if rows is not None and getattr(sampler, "rows", None) is None:
                batch = {k: v[rows] for k, v in batch.items()}     # a host batch: the rank's rows
            batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
            dropout = stream_generator(config.data.seed + 2, state.step) if cfg.use_dropout else None
            state, aux = step_fn(state, batch, dropout)
            step = start + i + 1
            if step % cfg.log_every == 0 and rank == 0:
                aux_host = {k: float(v) for k, v in aux.items()}
                rate = cfg.log_every * config.data.batch_size / max(time.time() - t0, 1e-9)
                t0 = time.time()
                log_fn(f"step {step} | " + " ".join(f"{k}={v:.4f}" for k, v in sorted(aux_host.items()))
                       + f" | {rate:.1f} img/s")
                if cfg.checkpoint_dir:
                    os.makedirs(cfg.checkpoint_dir, exist_ok=True)
                    with open(os.path.join(cfg.checkpoint_dir, "train_metrics.jsonl"), "a") as f:
                        f.write(json.dumps({"step": step, "img_per_sec": round(rate, 1), **aux_host}) + "\n")
                if tb is not None:
                    tb.write(step, {"img_per_sec": rate, **aux_host})
            if cfg.checkpoint_every and step % cfg.checkpoint_every == 0:
                snapshot = whole(state)
                if rank == 0:
                    save_checkpoint(snapshot, cfg.checkpoint_dir)
    finally:
        if tb is not None:
            tb.close()
    return whole(state)
