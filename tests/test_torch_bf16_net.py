"""The port's fp net in bf16 against the JAX package's
``StyleTransferNet(dtype=bfloat16)``, the net ``cli serve`` serves by default.

The parameters stay fp32 and are cast at each layer; every output comes back
fp32. The two packages round in different places (XLA keeps fp32 inside
fused elementwise chains, eager torch rounds after each op), so the outputs
are held to the int8 path's rule of tests/test_torch_retrieval.py: amp_foc
within 2e-2 of max|ref|, distance_pred within 1e-2 (one bf16 ulp of a
distance near 1 is 3.9e-3), the zero-meaned ph_foc within 3e-2 rad modulo
2 pi in at least 99.9 % of the pixels, the batch PSNR within 0.3 dB. Measured
on a CPU: the seeded width-0.25 net at 32^2 amp_foc 1.1e-2 and distance 0;
the ``fast`` release's golden batch 10 see the test's printout. The whole
suite is held to the int8 rule of PERF.md section 2 against the JAX package's
record ``checkpoints/fast/bf16_golden_metrics.json``: mean PSNR within 0.05
dB, R² within 1e-4 (measured: 0.0004 dB and 9.1e-6).
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_cpu_threads import warm_torch_threads  # noqa: F401

from style_transfer_based_holographic_imaging_tpu.config import ExperimentConfig as JConfig
from style_transfer_based_holographic_imaging_tpu.models.net import init_net_params
from style_transfer_based_holographic_imaging_tpu.pipelines import field_retrieval as jfr
from style_transfer_based_holographic_imaging_tpu_torch import ExperimentConfig, PhysicsConfig
from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite
from style_transfer_based_holographic_imaging_tpu_torch.eval import metrics as tmetrics
from style_transfer_based_holographic_imaging_tpu_torch.interop import (
    convert_params,
    load_release_weights,
    load_style_vector,
)
from style_transfer_based_holographic_imaging_tpu_torch.models import StyleTransferNet, quant
from style_transfer_based_holographic_imaging_tpu_torch.models.net import style_stats_nchw
from style_transfer_based_holographic_imaging_tpu_torch.pipelines import (
    evaluate_golden_suite,
    make_retrieval_fn,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST = os.path.join(REPO, "checkpoints", "fast")
BF16 = torch.bfloat16
AMP_TOL, DIST_TOL, PHASE_TOL, PHASE_FRACTION, BATCH_DB = 2e-2, 1e-2, 3e-2, 0.999, 0.3
SUITE_DB, SUITE_R2 = 0.05, 1e-4


def _fast_config():
    with open(os.path.join(FAST, "config.json")) as f:
        text = f.read()
    return ExperimentConfig.from_json(text), JConfig.from_json(text)


@pytest.fixture(scope="module")
def seeded():
    """A seeded width-0.25 net at 32^2 in both packages, and its inputs."""
    w, n = 0.25, 32
    params = jax.device_get(jax.jit(lambda k: init_net_params(k, image_size=n, width=w))(jax.random.key(0)))
    net = StyleTransferNet.from_state_dict(convert_params(params), w)
    rng = np.random.default_rng(0)
    holo = (rng.random((3, 1, n, n)) + 0.05).astype(np.float32)
    sm = rng.normal(size=(1, 1, 1, 128)).astype(np.float32)
    ss = (0.5 + rng.random((1, 1, 1, 128))).astype(np.float32)
    return params, net, w, (holo, sm, ss, 0.2), None


@pytest.fixture(scope="module")
def fast():
    """The ``fast`` release in both packages and its golden batch 10."""
    ocp = pytest.importorskip("orbax.checkpoint")
    params = ocp.StandardCheckpointer().restore(os.path.join(FAST, "release"))["params"]
    cfg, _ = _fast_config()
    net = StyleTransferNet.from_state_dict(load_release_weights(os.path.join(FAST, "torch_weights.npz")),
                                           cfg.model.width)
    sm, ss = load_style_vector(os.path.join(FAST, "style_vector.npz"))
    g = load_golden_suite()
    return params, net, cfg.model.width, (g.content_holo[10], sm, ss, g.distance_style[10]), g.gt_phase[10]


def _held_to_the_int8_rule(got, ref, gt_phase):
    for key in ref:
        assert got[key].dtype == torch.float32 and tuple(got[key].shape) == ref[key].shape, key
    amp_err = np.abs(got["amp_foc"].numpy() - ref["amp_foc"]).max() / np.abs(ref["amp_foc"]).max()
    dist_err = np.abs(got["distance_pred"].numpy() - ref["distance_pred"]).max()
    zm = lambda x: x - x.mean(axis=(-2, -1), keepdims=True)  # noqa: E731
    dph = zm(got["ph_foc"].numpy()) - zm(ref["ph_foc"])
    within = (np.abs(np.mod(dph + math.pi, 2 * math.pi) - math.pi) < PHASE_TOL).mean()
    print(f"amp_foc {amp_err:.3g}, distance {dist_err:.3g}, phase within {PHASE_TOL} rad {within:.6f}")
    assert amp_err < AMP_TOL
    assert dist_err < DIST_TOL
    assert within >= PHASE_FRACTION
    if gt_phase is not None:
        gt = tmetrics.zero_mean(torch.as_tensor(gt_phase))
        psnr = [float(tmetrics.psnr(tmetrics.zero_mean(torch.as_tensor(np.array(p))), gt))
                for p in (got["ph_foc"], ref["ph_foc"])]
        print(f"PSNR port {psnr[0]:.5f}, JAX {psnr[1]:.5f}")
        assert abs(psnr[0] - psnr[1]) < BATCH_DB


@pytest.mark.parametrize("case", ["seeded", "fast"])
def test_bf16_net_matches_jax(case, request):
    params, net, width, (holo, sm, ss, d_style), gt_phase = request.getfixturevalue(case)
    ref = jfr.make_retrieval_fn(JConfig().physics, width=width, dtype=jnp.bfloat16)(
        params, jnp.asarray(holo), jnp.asarray(sm), jnp.asarray(ss), d_style)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = make_retrieval_fn(PhysicsConfig(), dtype=BF16, device="cpu")(net, holo, sm, ss, d_style)
    _held_to_the_int8_rule(got, ref, gt_phase)


def test_bf16_suite_reproduces_the_jax_record(fast):
    _, net, _, _, _ = fast
    cfg, _ = _fast_config()
    with open(os.path.join(FAST, "bf16_golden_metrics.json")) as f:
        rec = json.load(f)
    style = load_style_vector(os.path.join(FAST, "style_vector.npz"))
    got = evaluate_golden_suite(net, load_golden_suite(), cfg, style_override=style, dtype=BF16,
                                device="cpu")
    print(f"bf16 suite: mean {got['mean_psnr']:.5f} (record {rec['mean_psnr']:.5f}), "
          f"R² {got['r2']:.7f} (record {rec['r2']:.7f})")
    assert abs(got["mean_psnr"] - rec["mean_psnr"]) < SUITE_DB
    assert abs(got["r2"] - rec["r2"]) < SUITE_R2


def test_bf16_net_is_the_int8_paths_fp_layers_bit_for_bit(seeded):
    # With no int8 scales and the stem unfolded, the int8 path's encoder and
    # decoder are the fp net's layers in the compute dtype.
    _, net, _, (holo, sm, ss, _), _ = seeded
    content = torch.sqrt(torch.as_tensor(holo))
    with torch.no_grad():
        feat = net.encode(content, BF16)
        assert feat.dtype == BF16
        assert torch.equal(feat, quant.quant_encode(net.encoder, content, compute_dtype=BF16, fold_stem=False))
        t = torch.randn(feat.shape, generator=torch.Generator().manual_seed(1))
        assert torch.equal(net.decoder(t, BF16), quant.quant_decode(net.decoder, t, compute_dtype=BF16))


def test_the_nets_dtype_is_the_default_and_checked(seeded):
    _, net, _, (holo, sm, ss, _), _ = seeded
    args = (torch.sqrt(torch.as_tensor(holo)), style_stats_nchw(torch.as_tensor(sm)),
            style_stats_nchw(torch.as_tensor(ss)))
    with torch.no_grad():
        default = net.field_retrieval(*args, unknown_distance=True)
        fp32 = net.field_retrieval(*args, unknown_distance=True, dtype=torch.float32)
        bf16 = net.field_retrieval(*args, unknown_distance=True, dtype=BF16)
        with pytest.raises(ValueError):
            net.field_retrieval(*args, dtype=torch.float16)
    assert all(a.dtype == torch.float32 and torch.equal(a, b) for a, b in zip(default, fp32))
    assert all(a.dtype == BF16 for a in bf16)
    assert all(p.dtype == torch.float32 for p in net.parameters())
