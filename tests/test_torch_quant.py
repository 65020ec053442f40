"""The port's int8 serving path (``models/quant.py``) against the JAX package's.

Width 0.25 on 32^2 inputs, as tests/test_quant.py; weights from the JAX
initializer, converted; inputs from numpy seeds. Tolerances:

* the fp fallback (``scales=None``, fp32) against the port's own fp net:
  ``atol 1e-5``, the JAX package's budget for the same check
  (tests/test_quant.py);
* calibrated scales against JAX's: ``1e-6`` relative. Both run the fp32
  fallback and differ only in the order of fp32 sums;
* the int8 forward in fp32 compute, stacks off and on: ``1e-4`` of max|ref|.
  The int32 sums are exact in both, so the only differences are fp32
  summation order in the fp parts and the rare activation that sits on a
  quantization tie and rounds to the other integer;
* one int8 conv: the int32 accumulator bit for bit, the dequantized output
  to ``1e-6`` of max|ref| (one multiply-add in fp32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_based_holographic_imaging_tpu.models import init_net_params
from style_transfer_based_holographic_imaging_tpu.models import quant as jquant
from style_transfer_based_holographic_imaging_tpu_torch.interop import convert_params
from style_transfer_based_holographic_imaging_tpu_torch.models import StyleTransferNet
from style_transfer_based_holographic_imaging_tpu_torch.models import quant

WIDTH = 0.25
SIZE = 32
FWD_TOL = 1e-4


def _rel(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _nets(phase_decoder=False):
    params = jax.device_get(
        init_net_params(
            jax.random.PRNGKey(0), image_size=SIZE, width=WIDTH, with_phase_decoder=phase_decoder
        )
    )
    net = StyleTransferNet(width=WIDTH, with_phase_decoder=phase_decoder)
    net.load_state_dict(convert_params(params), strict=True)
    return params, net.eval()


def _inputs(c, seed=1):
    rng = np.random.default_rng(seed)
    content = (rng.random((2, 1, SIZE, SIZE), np.float32) * 0.8).astype(np.float32)
    sm = rng.standard_normal((1, 1, 1, c)).astype(np.float32)
    ss = (rng.random((1, 1, 1, c)) + 0.5).astype(np.float32)
    return content, sm, ss


def _nchw_stats(s):
    return torch.as_tensor(s).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def small():
    params, net = _nets()
    c = net.encoder.out_channels
    content, sm, ss = _inputs(c)
    scales = jquant.calibrate_scales(
        params, [np.transpose(content, (0, 2, 3, 1))], sm, ss, compute_dtype=jnp.float32
    )
    return params, net, content, sm, ss, scales


@pytest.fixture
def stacks():
    yield
    quant.set_fused_stacks("off")
    jquant.set_fused_stacks("off")


def _jax_forward(params, content, sm, ss, scales):
    out = jquant.quant_retrieval_forward(
        params, jnp.asarray(np.transpose(content, (0, 2, 3, 1))), jnp.asarray(sm), jnp.asarray(ss),
        scales=scales, compute_dtype=jnp.float32,
    )
    amp, ph, d = (np.asarray(a) for a in out)
    return np.transpose(amp, (0, 3, 1, 2)), np.transpose(ph, (0, 3, 1, 2)), d


def test_fp_fallback_matches_the_fp_net(small):
    _, net, content, sm, ss, _ = small
    c, m, s = torch.as_tensor(content), _nchw_stats(sm), _nchw_stats(ss)
    with torch.inference_mode():
        ref = net.field_retrieval(c, m, s, unknown_distance=True)
        got = quant.quant_retrieval_forward(net, c, m, s, scales=None, compute_dtype=torch.float32)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-5)


def test_calibrated_scales_match_jax(small):
    _, net, content, sm, ss, jscales = small
    scales = quant.calibrate_scales(
        net, [content], sm, ss, compute_dtype=torch.float32, device="cpu"
    )
    assert set(scales) == set(jscales)
    assert any(k.startswith("encoder.") for k in scales)
    assert any(k.startswith("decoder.") for k in scales)
    for k in scales:
        assert abs(scales[k] - jscales[k]) <= 1e-6 * abs(jscales[k]), k


@pytest.mark.parametrize("mode", ["off", "on"])
def test_int8_forward_matches_jax(small, stacks, mode):
    params, net, content, sm, ss, scales = small
    quant.set_fused_stacks(mode)
    jquant.set_fused_stacks(mode)
    ref = _jax_forward(params, content, sm, ss, scales)
    with torch.inference_mode():
        got = quant.quant_retrieval_forward(
            net, torch.as_tensor(content), _nchw_stats(sm), _nchw_stats(ss),
            scales=scales, compute_dtype=torch.float32,
        )
    for name, g, r in zip(("amp", "phase", "distance"), got, ref):
        assert tuple(g.shape) == r.shape, name
        assert _rel(g.numpy(), r) < FWD_TOL, name


def test_int8_conv_valid_matches_jax(small):
    _, net, content, sm, ss, scales = small
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, 12, 10)).astype(np.float32)
    conv = net.decoder.conv8
    k_oihw = conv.weight.detach().numpy()
    k_hwio = np.transpose(k_oihw, (2, 3, 1, 0))
    bias = conv.bias.detach().numpy()
    act_max = float(np.abs(x).max() * 0.9)  # a few activations clip at +-127
    ref = jquant.int8_conv_valid(
        jnp.asarray(np.transpose(x, (0, 2, 3, 1))), jnp.asarray(k_hwio), jnp.asarray(bias),
        dt=jnp.float32, act_max=jnp.float32(act_max), relu=True,
        pad_fn=lambda q: jnp.pad(q, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="reflect"),
    )
    got = quant.int8_conv_valid(
        torch.as_tensor(x), conv.weight.detach(), conv.bias.detach(), dt=torch.float32,
        act_max=torch.tensor(act_max), relu=True,
    )
    assert _rel(got.numpy(), np.transpose(np.asarray(ref), (0, 3, 1, 2))) < 1e-6

    # The int32 accumulator on the same quantized operands, bit for bit.
    xq = rng.integers(-127, 128, size=(2, 16, 12, 10)).astype(np.int8)
    kq = rng.integers(-127, 128, size=(8, 16, 3, 3)).astype(np.int8)
    xq_pad = np.pad(xq, ((0, 0), (0, 0), (1, 1), (1, 1)), mode="reflect")
    acc = quant._int8_conv(torch.as_tensor(xq_pad), torch.as_tensor(kq))
    acc_ref = jax.lax.conv_general_dilated(
        jnp.asarray(np.transpose(xq_pad, (0, 2, 3, 1))), jnp.asarray(np.transpose(kq, (2, 3, 1, 0))),
        (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32,
    )
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.transpose(np.asarray(acc_ref), (0, 3, 1, 2)))


def test_scales_round_trip(small, tmp_path):
    scales = small[5]
    path = str(tmp_path / "scales.json")
    quant.save_scales(scales, path)
    assert quant.load_scales(path) == {k: float(v) for k, v in scales.items()}
    jscales = jquant.load_scales(path)
    assert jscales == quant.load_scales(path)


def test_phase_decoder_branch_matches_jax():
    params, net = _nets(phase_decoder=True)
    content, sm, ss = _inputs(net.encoder.out_channels, seed=2)
    scales = quant.calibrate_scales(
        net, [content], sm, ss, compute_dtype=torch.float32, device="cpu"
    )
    assert any(k.startswith("decoder_ph.") for k in scales)
    ref = _jax_forward(params, content, sm, ss, scales)
    with torch.inference_mode():
        got = quant.quant_retrieval_forward(
            net, torch.as_tensor(content), _nchw_stats(sm), _nchw_stats(ss),
            scales=scales, compute_dtype=torch.float32,
        )
    for name, g, r in zip(("amp", "phase", "distance"), got, ref):
        assert _rel(g.numpy(), r) < FWD_TOL, name


def test_set_fused_stacks_rejects_unknown_modes(stacks):
    with pytest.raises(ValueError):
        quant.set_fused_stacks("pallas")
    quant.set_fused_stacks("auto")
    assert not quant._use_fused(torch.zeros(1, 1, 8, 8), None)
    quant.set_fused_stacks("on")
    assert quant._use_fused(torch.zeros(1, 1, 8, 8), None)
    assert not quant._use_fused(torch.zeros(1, 1, 8, 8), quant._Observer())
    assert not quant._use_fused(torch.zeros(1, 1, 6, 7), None)
