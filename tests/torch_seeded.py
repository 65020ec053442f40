"""Shared by the port's export and command tests: a seeded net from numpy.

``seeded_params`` fills the JAX package's parameter tree (its shapes from
``jax.eval_shape`` of ``init_net_params``, nothing compiled) with numpy
draws: He-normal kernels (std sqrt(2 / fan_in), fan_in as each layer sums:
H W C_in for a conv, C_in for a transposed conv, the input width for a dense
layer) and N(0, 0.01^2) biases; the decoder's last conv scaled by 0.1 with
an amplitude bias of 0.6 (the golden suite's amplitude), so that the
retrieved field sits near a trained net's, 0.5 to 1.1, and its refocused
phase is well conditioned (a field through zero has pixels whose phase any
rounding turns). ``seeded_net`` carries the same tree into the port
through the weight bridge (``interop.convert_params``), so both packages
run the same weights.
"""

import jax
import numpy as np

from style_transfer_based_holographic_imaging_tpu.models.net import init_net_params
from style_transfer_based_holographic_imaging_tpu_torch.interop import convert_params
from style_transfer_based_holographic_imaging_tpu_torch.models import StyleTransferNet


def seeded_params(width: float, image_size: int, seed: int = 0):
    tree = jax.eval_shape(lambda k: init_net_params(k, image_size=image_size, width=width),
                          jax.random.key(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['bias']"):
            return (0.01 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if "['up" in name or len(leaf.shape) == 2:
            fan_in = leaf.shape[0]
        else:
            fan_in = int(np.prod(leaf.shape[:-1]))
        return (rng.standard_normal(leaf.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, tree)
    last = params["params"]["decoder"]["conv10"]
    last["kernel"] = last["kernel"] * np.float32(0.1)
    last["bias"] = np.asarray([0.6, 0.0], np.float32)
    return params


def seeded_net(params, width: float) -> StyleTransferNet:
    net = StyleTransferNet(width=width)
    net.load_state_dict(convert_params(params), strict=True)
    return net.eval()


def seeded_style(channels: int, seed: int = 1):
    """(mean, std) ``(1, 1, 1, C)`` style statistics in the JAX layout."""
    rng = np.random.default_rng(seed)
    return (rng.random((1, 1, 1, channels), np.float32),
            (0.5 + rng.random((1, 1, 1, channels))).astype(np.float32))
