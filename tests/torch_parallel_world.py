"""The rank side of ``tests/test_torch_parallel.py``: what each process of a
spawned ``gloo`` world on the CPU runs, in a module that imports no JAX (each
rank imports it afresh).

``world_checks`` runs every case of ``cases`` in turn, each on a mesh of the
whole world: one train step from the same params on the rank's rows of the
same batch, under a partition, and the state gathered whole after it (with
the local shapes of one leaf and its moment, which show the layout); with
``train_dir``, ``train(partition="fsdp")`` for two steps from a fresh state,
one snapshot a step, and the first snapshot restored and trained on for one
step under ``zero1``, its shards gathered back first.
"""

import dataclasses

import numpy as np
import torch

from style_transfer_based_holographic_imaging_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    PhysicsConfig,
    TrainConfig,
)
from style_transfer_based_holographic_imaging_tpu_torch.models import PatchDiscriminator, StyleTransferNet
from style_transfer_based_holographic_imaging_tpu_torch.parallel import (
    gather_state,
    local_rows,
    make_mesh,
    partition_state_shardings,
    shard_state,
)
from style_transfer_based_holographic_imaging_tpu_torch.train import (
    TrainStep,
    create_train_state,
    restore_checkpoint,
    train,
)

WIDTH, IMAGE, BATCH = 0.25, 64, 4
DATA = DataConfig(batch_size=BATCH, image_size=IMAGE, digit_pad=16)
LEAF = "decoder.conv0.weight"
# A narrow discriminator (the default one's widest conv holds 33 M weights):
# the adversarial cases check how its step is combined, not its width.
DISC = dict(image_size=IMAGE, conv_dim=8)
DROPOUT_SEED = 11

#: name: (mesh axes, mesh shape, partition, TrainConfig overrides)
CASES = {
    "dp": (("data",), (2,), "dp", {}),
    "dp_tv": (("data",), (2,), "dp", {"tv_weight": 0.5}),
    # the default clip: its params are held to the one-process step's by
    # the JAX package's rtol/atol, which one element whose gradient lies
    # near Adam's eps misses without it (fp32 order: 5.8e-6 in the distance
    # head); the moments without the clip are the next case's
    "dp_accum_dropout": (("data",), (2,), "dp", {"grad_accum": 2, "use_dropout": True,
                                                 "grad_clip_norm": 1.0}),
    "dp_accum_noclip": (("data",), (2,), "dp", {"grad_accum": 2, "use_dropout": True}),
    "zero1": (("data",), (2,), "zero1", {}),
    "fsdp": (("data",), (2,), "fsdp", {}),
    "fsdp_adv": (("data",), (2,), "fsdp", {"adv_weight": 1.0, "ema_decay": 0.999}),
    "tp": (("data", "model"), (1, 2), "tp", {}),
    # a clip far below the gradient's norm: the clip's factor reaches every
    # moment, so a norm summed wrong over the shards shows in them
    "dp_clip": (("data",), (2,), "dp", {"grad_clip_norm": 1e-3}),
    "fsdp_clip": (("data",), (2,), "fsdp", {"grad_clip_norm": 1e-3}),
    "tp_clip": (("data", "model"), (1, 2), "tp", {"grad_clip_norm": 1e-3}),
    # the discriminator, the EMA and the encoder trained too
    "tp_fsdp": (("data", "model"), (2, 2), "tp_fsdp", {"adv_weight": 1.0, "ema_decay": 0.999,
                                                      "freeze_encoder": False}),
}


#: What every case's TrainConfig changes from the default: no adversarial
#: term, and no clip (the default's 1.0 lies below this step's norm, and a
#: clip that acts makes the step blind to a gradient scaled on every rank).
BASE_TRAIN = {"checkpoint_every": 0, "adv_weight": 0.0, "grad_clip_norm": 0.0}


def train_config(**kw) -> TrainConfig:
    return TrainConfig(**{**BASE_TRAIN, **kw})


def step_once(inputs, case, mesh=None, rank=0):
    """One step of ``case`` from ``inputs``' params and batch: (aux, the state
    after it). With a mesh, on the rank's shards and rows, the state gathered
    whole, and the local shapes of ``LEAF`` and its first moment."""
    _, _, partition, kw = CASES[case]
    cfg = train_config(**kw)
    adv = bool(cfg.adv_weight)
    state = create_train_state(inputs["params"], cfg, device="cpu",
                               disc_params=inputs["disc_params"] if adv else None)
    batch = inputs["batch"]
    plan = None
    if mesh is not None:
        plan = partition_state_shardings(partition, state, mesh)
        state = shard_state(state, plan, rank)
        batch = {k: v[local_rows(BATCH, mesh, rank, "data", cfg.grad_accum)] for k, v in batch.items()}
    disc = PatchDiscriminator(**DISC) if adv else None
    step = TrainStep(StyleTransferNet(width=WIDTH), PhysicsConfig(), cfg, disc=disc, mesh=mesh,
                     state_shardings=plan)
    dropout = torch.Generator().manual_seed(DROPOUT_SEED) if cfg.use_dropout else None
    state, aux = step(state, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()},
                      dropout)
    shapes = None
    if mesh is not None:
        shapes = {"params": tuple(state.params[LEAF].shape), "mu": tuple(state.opt_state.mu[LEAF].shape)}
        state = gather_state(state, plan)
    return {k: float(v) for k, v in aux.items()}, state, shapes


def run_config(train_dir: str, bank: np.ndarray, **kw) -> ExperimentConfig:
    return ExperimentConfig(
        model=ModelConfig(width=WIDTH, image_size=IMAGE), data=DATA,
        train=TrainConfig(iterations=2, checkpoint_every=1, log_every=1, checkpoint_dir=train_dir,
                          **kw))


def world_checks(rank, inputs, cases, train_dir=None):
    """The results of ``cases`` (and, with ``train_dir``, of the train runs)
    on this rank; numpy trees."""
    n = torch.distributed.get_world_size()
    out = {}
    for case in cases:
        axes, shape, _, _ = CASES[case]
        mesh = make_mesh(devices=["cpu"] * n, axis_names=axes, shape=shape)
        aux, state, shapes = step_once(inputs, case, mesh, rank)
        out[case] = {"aux": aux, "shapes": shapes, "params": state.params, "ema": state.ema_params,
                     "disc": state.disc_params, "mu": state.opt_state.mu,
                     "disc_mu": None if state.disc_opt_state is None else state.disc_opt_state.mu}
    if train_dir is not None:
        mesh = make_mesh(devices=["cpu"] * n)
        cfg = run_config(train_dir, inputs["bank"])
        whole = train(cfg, bank=inputs["bank"], mesh=mesh, partition="fsdp", device="cpu",
                      log_fn=lambda _: None)
        # the first snapshot into another partition: shards and back, then on
        fresh = create_train_state(inputs["params"], cfg.train, device="cpu")
        snap = restore_checkpoint(f"{train_dir}/iter_1", fresh)
        plan = partition_state_shardings("zero1", snap, mesh)
        back = gather_state(shard_state(snap, plan, rank), plan)
        round_trip = max(float((back.params[k] - snap.params[k]).abs().max()) for k in snap.params)
        resume_cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, checkpoint_every=0,
                                                                        checkpoint_dir=""))
        resumed = train(resume_cfg, bank=inputs["bank"], state=snap, iterations=1, mesh=mesh,
                        partition="zero1", device="cpu", log_fn=lambda _: None)
        out["train"] = {"params": whole.params, "step": whole.step, "round_trip": round_trip,
                        "resumed": resumed.params, "resumed_step": resumed.step}
    return out
