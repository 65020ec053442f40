"""Training: losses, the optax-faithful train state, the loop, checkpoints."""

from style_transfer_based_holographic_imaging_tpu_torch.train.losses import (
    distance_loss,
    lsgan_d_loss,
    lsgan_g_loss,
    physics_cycle_loss,
    tv_loss,
)
from style_transfer_based_holographic_imaging_tpu_torch.train.state import (
    Adam,
    AdamState,
    TrainState,
    create_train_state,
    latest_snapshot,
    load_release_params,
    load_train_params,
    restore_checkpoint,
    save_checkpoint,
)
from style_transfer_based_holographic_imaging_tpu_torch.train.loop import (
    TrainStep,
    compute_dtype,
    generator_loss_fn,
    train,
)

__all__ = [
    "tv_loss",
    "physics_cycle_loss",
    "distance_loss",
    "lsgan_d_loss",
    "lsgan_g_loss",
    "Adam",
    "AdamState",
    "TrainState",
    "create_train_state",
    "save_checkpoint",
    "restore_checkpoint",
    "latest_snapshot",
    "load_train_params",
    "load_release_params",
    "generator_loss_fn",
    "TrainStep",
    "train",
    "compute_dtype",
]
