"""The ``fast`` release's weights as the port reads them on the card.

``checkpoints/fast/torch_weights.npz`` (``scripts/port_golden_eval.py
--export-npz``) must hold exactly ``convert_params`` of the orbax restore of
``checkpoints/fast/release``, bit for bit and key for key, so that a
re-promoted release cannot leave a stale copy; and it must load into the
port's net with ``strict=True`` at the width of the release's config.
"""

import json
import os

import numpy as np
import pytest
import torch

from style_transfer_based_holographic_imaging_tpu_torch.interop import (
    convert_params,
    load_release_weights,
)
from style_transfer_based_holographic_imaging_tpu_torch.models import StyleTransferNet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST = os.path.join(REPO, "checkpoints", "fast")
NPZ = os.path.join(FAST, "torch_weights.npz")


@pytest.fixture(scope="module")
def npz_state():
    return load_release_weights(NPZ)


def test_npz_equals_converted_orbax_release(npz_state):
    ocp = pytest.importorskip("orbax.checkpoint")
    params = ocp.StandardCheckpointer().restore(os.path.join(FAST, "release"))["params"]
    want = convert_params(params)
    assert set(npz_state) == set(want)
    for k, v in want.items():
        assert npz_state[k].dtype == torch.float32 and npz_state[k].shape == v.shape, k
        assert torch.equal(npz_state[k], v), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_npz_loads_strict_at_the_release_width(npz_state, dtype):
    with open(os.path.join(FAST, "config.json")) as f:
        width = json.load(f)["model"]["width"]
    net = StyleTransferNet.from_state_dict(npz_state, width)
    assert net.width == 0.5 and not net.with_phase_decoder
    assert sum(p.numel() for p in net.parameters()) == 4_539_945
    with torch.no_grad():
        assert net.encode(torch.rand(1, 1, 16, 16), dtype).dtype == dtype
    assert all(p.dtype == torch.float32 for p in net.parameters())
    with pytest.raises(RuntimeError):
        StyleTransferNet.from_state_dict(npz_state, 0.25)


def test_a_file_that_is_not_float32_is_refused(tmp_path):
    path = tmp_path / "w.npz"
    np.savez(path, **{"distance_g.out.bias": np.zeros(1, np.float64)})
    with pytest.raises(ValueError, match="float32"):
        load_release_weights(str(path))
