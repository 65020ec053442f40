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
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
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
from style_transfer_based_holographic_imaging_tpu_torch.models.layers import at_least_fp32
from style_transfer_based_holographic_imaging_tpu_torch.models.net import (
    StyleTransferNet,
    init_net_params,
    init_params,
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


class TrainStep:
    """One optimizer step (the JAX ``make_train_step``), in place on the
    state: the generator's gradients (averaged over ``grad_accum``
    micro-batches), its update and EMA, then the discriminator's update from
    its params before the step and the detached ``g_t`` of the forward.
    ``dtype`` is the network's compute dtype (``compute_dtype``); the
    discriminator and the optimizer stay fp32."""

    def __init__(self, net: StyleTransferNet, physics: PhysicsConfig, cfg: TrainConfig, *,
                 disc: Optional[PatchDiscriminator] = None, dtype: torch.dtype = torch.float32):
        if cfg.grad_accum > 1 and cfg.adv_weight:
            raise ValueError("grad_accum > 1 is not supported with the adversarial term "
                             "(the discriminator update would see stale generator outputs)")
        self.net, self.physics, self.cfg, self.disc, self.dtype = net, physics, cfg, disc, dtype
        self.tx = make_optimizer(cfg)
        self.disc_tx = make_disc_optimizer(cfg)

    def generator_grads(self, state: TrainState, batch, dropout=None):
        """(gradients of the optimized names, aux with ``g_t``)."""
        params = {k: v.detach().requires_grad_(self.tx.trainable(k)) for k, v in state.params.items()}
        wrt = [k for k in params if params[k].requires_grad]
        kw = dict(net=self.net, physics=self.physics, cfg=self.cfg,
                  disc_params=state.disc_params, disc=self.disc, dropout=dropout, dtype=self.dtype)
        k = self.cfg.grad_accum
        if k <= 1:
            loss, aux = generator_loss_fn(params, batch, **kw)
            grads = _grads(loss, [params[n] for n in wrt])
            return dict(zip(wrt, grads)), _detached(aux)
        b = batch["content_holo"].shape[0]
        if b % k:
            raise ValueError(f"batch size {b} must divide by grad_accum={k}")
        total, total_aux = None, None
        for i in range(k):
            micro = {n: v[i * (b // k):(i + 1) * (b // k)] for n, v in batch.items()}
            loss, aux = generator_loss_fn(params, micro, **kw)
            aux.pop("g_t")
            grads = _grads(loss, [params[n] for n in wrt])
            aux = _detached(aux)
            if total is None:
                total, total_aux = list(grads), aux
            else:
                total = [t + g for t, g in zip(total, grads)]
                total_aux = {n: total_aux[n] + aux[n] for n in total_aux}
        inv_k = 1.0 / k
        return ({n: g * inv_k for n, g in zip(wrt, total)},
                {n: a * inv_k for n, a in total_aux.items()})

    def apply(self, state: TrainState, grads: Params) -> None:
        apply_gradients(state, grads, self.tx, self.cfg.ema_decay)

    def disc_step(self, state: TrainState, fake: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
        """The discriminator's LSGAN step on ``real`` and ``fake`` (in fp32,
        whatever the generator's dtype); its loss."""
        dp = {k: v.detach().requires_grad_() for k, v in state.disc_params.items()}
        real_logits, _ = functional_call(self.disc, dp, (at_least_fp32(real),))
        fake_logits, _ = functional_call(self.disc, dp, (at_least_fp32(fake),))
        d_loss = lsgan_d_loss(real_logits, fake_logits)
        grads = _grads(d_loss, list(dp.values()))
        apply_disc_gradients(state, dict(zip(dp, grads)), self.disc_tx)
        return d_loss.detach()

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
    """
    cfg, physics = config.train, config.physics
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

    if sampler is None:
        sampler = InfiniteHologramSampler(
            sklearn_digit_bank() if bank is None else bank, config.data, physics,
            return_gt=bool(cfg.supervised_weight), start_iteration=state.step, device=device)
    else:
        sampler.iteration = state.step
    step_fn = TrainStep(net, physics, cfg, disc=disc, dtype=dtype)
    n_iter = max(cfg.iterations - state.step, 0) if iterations is None else iterations

    start = state.step
    tb = make_writer(cfg.tensorboard_dir)
    t0 = time.time()
    try:
        for i, batch in zip(range(n_iter), sampler):
            batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
            dropout = stream_generator(config.data.seed + 2, state.step) if cfg.use_dropout else None
            state, aux = step_fn(state, batch, dropout)
            step = start + i + 1
            if step % cfg.log_every == 0:
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
                save_checkpoint(state, cfg.checkpoint_dir)
    finally:
        if tb is not None:
            tb.close()
    return state
