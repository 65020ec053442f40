"""The port's network modules against the flax modules of the JAX package,
on parameters made by ``init_net_params`` and carried across by
``convert_params``.

Small widths (0.125: 8-64 channels) and 32^2 inputs. Tolerance: 1e-4 of
max|ref| (convolutions sum in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_based_holographic_imaging_tpu.models import layers as jlayers
from style_transfer_based_holographic_imaging_tpu.models.decoder import AmpPhaseDecoder as JDecoder
from style_transfer_based_holographic_imaging_tpu.models.distance import DistanceMLP as JDistance
from style_transfer_based_holographic_imaging_tpu.models.net import (
    StyleTransferNet as JNet,
    init_net_params,
)
from style_transfer_based_holographic_imaging_tpu.models.vgg import VggEncoder as JVgg
from style_transfer_based_holographic_imaging_tpu_torch.interop import convert_params
from style_transfer_based_holographic_imaging_tpu_torch.models import (
    ConvTranspose2x2,
    ReflectConv,
    StyleTransferNet,
    has_phase_decoder,
    instance_norm_rows,
    max_pool_ceil,
    split_style_vector,
)

TOL = 1e-4
WIDTH = 0.125
N = 32


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _to_nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.fixture(scope="module")
def jax_params():
    """Parameters with and without the ``decoder_ph`` head (one jitted init;
    the other heads do not depend on it)."""
    init = jax.jit(
        lambda key: init_net_params(key, image_size=N, width=WIDTH, with_phase_decoder=True)
    )
    full = jax.device_get(init(jax.random.key(0)))
    plain = {"params": {k: v for k, v in full["params"].items() if k != "decoder_ph"}}
    return {False: plain, True: full}


@pytest.fixture(scope="module")
def nets(jax_params):
    out = {}
    for pd, params in jax_params.items():
        net = StyleTransferNet(width=WIDTH, with_phase_decoder=pd)
        net.load_state_dict(convert_params(params), strict=True)
        out[pd] = net.eval()
    return out


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_reflect_conv_matches_flax():
    x = _x((2, 9, 11, 5))
    mod = jlayers.ReflectConv(features=7)
    params = mod.init(jax.random.key(1), jnp.asarray(x))
    ref = mod.apply(params, jnp.asarray(x))
    conv = ReflectConv(5, 7)
    state = convert_params({"conv": params["params"]})
    conv.load_state_dict({"weight": state["conv.weight"], "bias": state["conv.bias"]})
    with torch.no_grad():
        got = conv(_nchw(x))
    assert _rel(_to_nhwc(got), ref) < TOL


@pytest.mark.parametrize("hw", [(8, 8), (7, 9), (5, 4)])
def test_max_pool_ceil_matches_jax(hw):
    x = _x((2,) + hw + (3,))
    ref = jlayers.max_pool_ceil(jnp.asarray(x))
    got = max_pool_ceil(_nchw(x))
    assert np.array_equal(_to_nhwc(got), np.asarray(ref))


def test_conv_transpose_2x2_tap_placement():
    x = _x((2, 5, 6, 4))
    mod = jlayers.ConvTranspose2x2(features=3)
    params = mod.init(jax.random.key(2), jnp.asarray(x))
    params = jax.tree.map(lambda a: a + 0.1, params)  # nonzero bias
    ref = mod.apply(params, jnp.asarray(x))
    up = ConvTranspose2x2(4, 3)
    up.load_state_dict({
        "weight": torch.tensor(np.asarray(params["params"]["kernel"])),
        "bias": torch.tensor(np.asarray(params["params"]["bias"])),
    })
    with torch.no_grad():
        got = up(_nchw(x))
    assert got.shape == (2, 3, 10, 12)
    assert _rel(_to_nhwc(got), ref) < TOL
    # the scatter rule itself: y[2i+di, 2j+dj, o] = sum_c x[i, j, c] W[c, o, di, dj]
    w = np.asarray(params["params"]["kernel"])
    b = np.asarray(params["params"]["bias"])
    want = np.einsum("nijc,code->nidjeo", x, w).reshape(2, 10, 12, 3) + b
    assert _rel(_to_nhwc(got), want) < TOL


def test_instance_norm_rows_matches_jax():
    x = _x((4, 64)) * 3.0 + 1.0
    got = instance_norm_rows(torch.from_numpy(x)).numpy()
    ref = np.asarray(jlayers.instance_norm_rows(jnp.asarray(x)))
    assert _rel(got, ref) < TOL


def test_vgg_all_taps_match_flax(jax_params, nets):
    x = np.abs(_x((2, N, N, 1)))
    ref = JVgg(width=WIDTH).apply(
        {"params": jax_params[False]["params"]["encoder"]}, jnp.asarray(x), all_taps=True
    )
    with torch.no_grad():
        got = nets[False].encoder(_nchw(x), all_taps=True)
    assert len(got) == 4
    for g, r in zip(got, ref):
        assert _rel(_to_nhwc(g), r) < TOL


def test_decoder_matches_flax(jax_params, nets):
    t = np.abs(_x((2, N // 8, N // 8, 64)))
    ref = JDecoder(width=WIDTH).apply(
        {"params": jax_params[False]["params"]["decoder"]}, jnp.asarray(t)
    )
    with torch.no_grad():
        got = nets[False].decoder(_nchw(t))
    assert got.shape == (2, 2, N, N)
    assert _rel(_to_nhwc(got), ref) < TOL


def test_distance_mlp_matches_flax_eval_mode(jax_params, nets):
    mean = _x((3, 1, 1, 64))
    std = np.abs(_x((3, 1, 1, 64), seed=1)) + 0.5
    ref = JDistance().apply(
        {"params": jax_params[False]["params"]["distance_g"]},
        (jnp.asarray(mean), jnp.asarray(std)),
        deterministic=True,
    )
    net = nets[False].distance_g
    net.train()  # no dropout in the port's forward: train/eval give the same
    with torch.no_grad():
        got = net((_nchw(mean), _nchw(std)))
    net.eval()
    assert got.shape == (3, 1)
    assert _rel(got.numpy(), ref) < TOL


@pytest.mark.parametrize("phase_decoder", [False, True])
@pytest.mark.parametrize("alpha", [1.0, 0.6])
def test_field_retrieval_matches_flax(jax_params, nets, phase_decoder, alpha):
    rng = np.random.default_rng(5)
    content = np.sqrt(rng.random((2, N, N, 1)).astype(np.float32) + 0.05)
    sm = rng.normal(size=(1, 1, 1, 64)).astype(np.float32)
    ss = (0.5 + rng.random((1, 1, 1, 64))).astype(np.float32)
    ref = JNet(width=WIDTH, with_phase_decoder=phase_decoder).apply(
        jax_params[phase_decoder], jnp.asarray(content), jnp.asarray(sm), jnp.asarray(ss),
        alpha, unknown_distance=True, method=JNet.field_retrieval,
    )
    sm_t, ss_t = split_style_vector(np.concatenate([sm, ss]))
    with torch.no_grad():
        got = nets[phase_decoder].field_retrieval(
            _nchw(content), sm_t, ss_t, alpha, unknown_distance=True
        )
    for g, r in zip(got[:2], ref[:2]):
        assert _rel(_to_nhwc(g), r) < TOL
    assert _rel(got[2].numpy(), ref[2]) < TOL


@pytest.mark.parametrize("phase_decoder", [False, True])
def test_convert_params_loads_strict(jax_params, phase_decoder):
    params = jax_params[phase_decoder]
    assert has_phase_decoder(params) == phase_decoder
    state = convert_params(params)
    assert has_phase_decoder(state) == phase_decoder
    assert convert_params(params["params"]).keys() == state.keys()
    net = StyleTransferNet(width=WIDTH, with_phase_decoder=phase_decoder)
    net.load_state_dict(state, strict=True)
    assert state["encoder.stem.weight"].shape == (3, 1, 1, 1)
    assert state["decoder.up0.weight"].shape == tuple(
        np.asarray(params["params"]["decoder"]["up0"]["kernel"]).shape
    )
    assert state["distance_g.l1.weight"].shape == (1024, 128)
    # the wrong head set does not load
    other = StyleTransferNet(width=WIDTH, with_phase_decoder=not phase_decoder)
    with pytest.raises(RuntimeError):
        other.load_state_dict(state, strict=True)


def test_split_style_vector_layouts():
    rng = np.random.default_rng(6)
    nhwc = rng.normal(size=(2, 1, 1, 16)).astype(np.float32)
    m, s = split_style_vector(nhwc)
    m2, s2 = split_style_vector(nhwc.transpose(0, 3, 1, 2))
    assert m.shape == (1, 16, 1, 1)
    assert torch.equal(m, m2) and torch.equal(s, s2)
    with pytest.raises(ValueError):
        split_style_vector(np.zeros((2, 16)))
