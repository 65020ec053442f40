"""Small host-side helpers."""

from style_transfer_based_holographic_imaging_tpu_torch.utils.misc import static_scalar

__all__ = ["static_scalar"]
