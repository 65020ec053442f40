"""``nn.Module`` networks: the field-retrieval net, the discriminator and
the reference's ablation families."""

from style_transfer_based_holographic_imaging_tpu_torch.models.ablations import (
    HoloAutoEncoder,
    TrivialSolutionNet,
)
from style_transfer_based_holographic_imaging_tpu_torch.models.decoder import AmpPhaseDecoder
from style_transfer_based_holographic_imaging_tpu_torch.models.discriminator import PatchDiscriminator
from style_transfer_based_holographic_imaging_tpu_torch.models.distance import DistanceMLP
from style_transfer_based_holographic_imaging_tpu_torch.models.layers import (
    ConvTranspose2x2,
    ReflectConv,
    instance_norm_rows,
    max_pool_ceil,
    set_reflect_backend,
)
from style_transfer_based_holographic_imaging_tpu_torch.models.net import (
    StyleTransferNet,
    has_phase_decoder,
    init_net_params,
    init_params,
    split_style_vector,
)
from style_transfer_based_holographic_imaging_tpu_torch.models.vgg import VggEncoder

__all__ = [
    "HoloAutoEncoder",
    "TrivialSolutionNet",
    "AmpPhaseDecoder",
    "DistanceMLP",
    "ConvTranspose2x2",
    "ReflectConv",
    "instance_norm_rows",
    "max_pool_ceil",
    "set_reflect_backend",
    "PatchDiscriminator",
    "StyleTransferNet",
    "has_phase_decoder",
    "init_net_params",
    "init_params",
    "split_style_vector",
    "VggEncoder",
]
