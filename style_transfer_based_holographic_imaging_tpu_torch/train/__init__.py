"""Training pieces of the port; so far the TV regulariser that physics
refinement needs."""

from style_transfer_based_holographic_imaging_tpu_torch.train.losses import tv_loss

__all__ = ["tv_loss"]
