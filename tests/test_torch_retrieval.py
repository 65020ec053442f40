"""The port's field-retrieval slice against the JAX package's.

* ``retrieval_step`` at small width (0.125) on 32^2 holograms, with a static
  and a per-sample style distance; ``evaluate_golden_suite`` on the first
  golden batches. Tolerance 1e-4 of max|ref| (the nets sum in another order);
  phases modulo whole cycles (a tie of the unwrap's congruence snap may move
  a pixel by 2 pi).
* the refocus routes: an all-equal style distance takes ``asm_const``, a
  per-sample one ``asm_dynamic``.
* the flagship release (``checkpoints/release``) restored with orbax,
  converted, and run by the port on the CPU on held-out golden batch 10;
  also on the int8 serving path with ``checkpoints/quant_scales.json`` in
  bf16, fused stacks off and on, against the JAX package on the same batch.
"""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_based_holographic_imaging_tpu.config import ExperimentConfig as JConfig
from style_transfer_based_holographic_imaging_tpu.config import ModelConfig as JModelConfig
from style_transfer_based_holographic_imaging_tpu.data import load_golden_suite as j_load_goldens
from style_transfer_based_holographic_imaging_tpu.models import quant as jquant
from style_transfer_based_holographic_imaging_tpu.models.net import init_net_params
from style_transfer_based_holographic_imaging_tpu.pipelines import field_retrieval as jfr
from style_transfer_based_holographic_imaging_tpu_torch import ExperimentConfig, ModelConfig
from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite
from style_transfer_based_holographic_imaging_tpu_torch.eval import metrics as tmetrics
from style_transfer_based_holographic_imaging_tpu_torch.interop import (
    convert_params,
    load_style_vector,
)
from style_transfer_based_holographic_imaging_tpu_torch.kernels import asm_cuda
from style_transfer_based_holographic_imaging_tpu_torch.models import (
    StyleTransferNet,
    has_phase_decoder,
    quant,
)
from style_transfer_based_holographic_imaging_tpu_torch.pipelines import (
    evaluate_golden_suite,
    make_retrieval_fn,
    retrieval_step,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4
WIDTH = 0.125


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _wrapped_max(got, ref):
    d = np.asarray(got) - np.asarray(ref)
    return np.abs(np.mod(d + math.pi, 2 * math.pi) - math.pi).max()


def _small(image_size):
    init = jax.jit(lambda key: init_net_params(key, image_size=image_size, width=WIDTH))
    params = jax.device_get(init(jax.random.key(0)))
    net = StyleTransferNet(width=WIDTH)
    net.load_state_dict(convert_params(params), strict=True)
    return params, net.eval()


@pytest.fixture(scope="module")
def small32():
    return _small(32)


def _inputs(b=3, n=32, seed=0):
    rng = np.random.default_rng(seed)
    holo = (rng.random((b, 1, n, n)) + 0.05).astype(np.float32)
    sm = rng.normal(size=(1, 1, 1, 64)).astype(np.float32)
    ss = (0.5 + rng.random((1, 1, 1, 64))).astype(np.float32)
    return holo, sm, ss


@pytest.mark.parametrize("distance", ["scalar", "per_sample"])
def test_retrieval_step_matches_jax(small32, distance):
    params, net = small32
    holo, sm, ss = _inputs()
    phys = ExperimentConfig().physics
    jphys = JConfig().physics
    d = 0.2 if distance == "scalar" else np.asarray([0.2, 0.3, 0.45], np.float32).reshape(3, 1, 1, 1)
    ref = jfr.retrieval_step(
        params, jnp.asarray(holo), jnp.asarray(sm), jnp.asarray(ss),
        d if distance == "scalar" else jnp.asarray(d), jphys,
        net=jfr.StyleTransferNet(width=WIDTH),
    )
    got = retrieval_step(net, holo, sm, ss, d, phys, device="cpu")
    assert set(got) == set(ref)
    for key in ("amp_field", "ph_field", "amp_foc", "distance_pred"):
        assert got[key].shape == ref[key].shape, key
        assert _rel(got[key].numpy(), ref[key]) < TOL, key
    scale = np.abs(np.asarray(ref["ph_foc"])).max()
    assert _wrapped_max(got["ph_foc"].numpy(), ref["ph_foc"]) < TOL * scale


def test_retrieval_step_rejects_a_net_on_another_device(small32):
    _, net = small32
    holo, sm, ss = _inputs()
    with pytest.raises(ValueError):
        retrieval_step(net, holo, sm, ss, 0.2, ExperimentConfig().physics, device="meta")


@pytest.mark.parametrize(
    "distance,kernel",
    [
        (0.2, "asm_const"),
        (np.full((3, 1, 1, 1), 0.2, np.float32), "asm_const"),
        (torch.full((3, 1, 1, 1), 0.2), "asm_const"),
        (np.asarray([0.2, 0.3, 0.4], np.float32).reshape(3, 1, 1, 1), "asm_dynamic"),
    ],
)
def test_style_distance_routes_to_its_kernel(small32, monkeypatch, distance, kernel):
    _, net = small32
    holo, sm, ss = _inputs()
    calls = []
    for name in ("asm_const", "asm_dynamic"):
        real = getattr(asm_cuda, name)
        monkeypatch.setattr(
            asm_cuda, name, lambda *a, _real=real, _name=name, **k: calls.append(_name) or _real(*a, **k)
        )
    fn = make_retrieval_fn(ExperimentConfig().physics, asm_backend="cuda", device="cpu")
    out = fn(net, holo, sm, ss, distance)
    assert calls == [kernel]
    ref = make_retrieval_fn(ExperimentConfig().physics, asm_backend="torch", device="cpu")(
        net, holo, sm, ss, distance
    )
    assert _rel(out["amp_foc"].numpy(), ref["amp_foc"].numpy()) < TOL


def test_evaluate_golden_suite_matches_jax():
    params, net = _small(128)
    goldens = load_golden_suite().subset(2)
    jgoldens = j_load_goldens().subset(2)
    cfg = dataclasses.replace(ExperimentConfig(), model=ModelConfig(width=WIDTH))
    jcfg = dataclasses.replace(JConfig(), model=JModelConfig(width=WIDTH))
    _, sm, ss = _inputs()  # 64-channel style statistics for the narrow net
    got = evaluate_golden_suite(net, goldens, cfg, style_override=(sm, ss), device="cpu")
    ref = jfr.evaluate_golden_suite(
        params, jgoldens, jcfg, style_override=(jnp.asarray(sm), jnp.asarray(ss))
    )
    assert set(got) == set(ref) - {"heldout_mean_psnr", "heldout_mean_mae", "heldout_r2"}
    np.testing.assert_allclose(got["psnr_per_batch"], ref["psnr_per_batch"], atol=1e-3)
    np.testing.assert_allclose(got["mae_per_batch"], ref["mae_per_batch"], rtol=TOL)
    np.testing.assert_allclose(got["distance_pred_um"], ref["distance_pred_um"], rtol=TOL)
    assert got["distance_true_um"] == ref["distance_true_um"]
    assert got["distance_outlier_batches"] == ref["distance_outlier_batches"]


def test_heldout_metrics_cover_batches_10_to_19():
    net = StyleTransferNet(width=WIDTH).eval()
    full = load_golden_suite()
    goldens = dataclasses.replace(
        full.subset(12),
        **{f: getattr(full, f)[[0, 1] * 5 + [10, 11]] for f in (
            "content_holo", "distance_style", "distance_content", "gt_amplitude", "gt_phase")},
    )
    _, sm, ss = _inputs()
    got = evaluate_golden_suite(
        net, goldens, dataclasses.replace(ExperimentConfig(), model=ModelConfig(width=WIDTH)),
        style_override=(sm, ss), device="cpu",
    )
    assert got["heldout_mean_psnr"] == pytest.approx(np.mean(got["psnr_per_batch"][10:12]))
    assert len(got["distance_pred_um"]) == 60


@pytest.fixture(scope="module")
def flagship():
    ocp = pytest.importorskip("orbax.checkpoint")
    release = os.path.join(REPO, "checkpoints", "release")
    params = ocp.StandardCheckpointer().restore(release)["params"]
    with open(os.path.join(REPO, "checkpoints", "config.json")) as f:
        cfg = ExperimentConfig.from_json(f.read())
    net = StyleTransferNet(width=cfg.model.width, with_phase_decoder=has_phase_decoder(params))
    net.load_state_dict(convert_params(params), strict=True)
    return params, net.eval(), cfg


def test_flagship_release_reproduces_golden_batch_10(flagship):
    """Held-out golden batch 10 through the converted flagship release."""
    params, net, cfg = flagship
    batch = 10
    sm, ss = load_style_vector(os.path.join(REPO, "checkpoints", "style_vector.npz"))
    goldens = load_golden_suite()
    got = make_retrieval_fn(cfg.physics, device="cpu")(
        net, goldens.content_holo[batch], sm, ss, goldens.distance_style[batch]
    )
    with open(os.path.join(REPO, "checkpoints", "config.json")) as f:
        jcfg = JConfig.from_json(f.read())
    ref = jfr.make_retrieval_fn(jcfg.physics, width=jcfg.model.width)(
        params, jnp.asarray(goldens.content_holo[batch]), jnp.asarray(sm), jnp.asarray(ss),
        goldens.distance_style[batch],
    )
    ref = {k: np.asarray(v) for k, v in ref.items()}

    assert _rel(got["amp_foc"].numpy(), ref["amp_foc"]) < 1e-4
    assert np.abs(got["distance_pred"].numpy() - ref["distance_pred"]).max() < 1e-4

    zm = lambda x: x - x.mean(axis=(-2, -1), keepdims=True)  # noqa: E731
    dph = zm(got["ph_foc"].numpy()) - zm(ref["ph_foc"])
    miss = np.abs(dph) >= 1e-4
    print(f"ph_foc pixels missing 1e-4 rad: {int(miss.sum())} of {dph.size}")
    assert miss.mean() <= 1e-4
    if miss.any():
        # a miss is a tie of the congruence snap: a whole number of cycles
        cycles = dph[miss] / (2 * math.pi)
        assert np.abs(cycles - np.round(cycles)).max() < 1e-4 / (2 * math.pi) + 1e-6

    gt = torch.as_tensor(goldens.gt_phase[batch])
    got_psnr = float(tmetrics.psnr(tmetrics.zero_mean(got["ph_foc"]), tmetrics.zero_mean(gt)))
    with open(os.path.join(REPO, "checkpoints", "golden_metrics.json")) as f:
        want = json.load(f)["psnr_per_batch"][batch]
    assert abs(got_psnr - want) < 0.3


# The int8 path in bf16, port against JAX. bf16 keeps about three significant
# digits and the two frameworks round in different places (XLA keeps fp32
# inside fused elementwise chains, eager torch rounds after each op), and a
# bf16 value one ulp apart may requantize to the neighbouring int8 step. So:
# amp_foc within 2e-2 of max|ref|; distance_pred within 1e-2 (one bf16 ulp of
# a distance near 1 is 3.9e-3); the zero-meaned ph_foc within 3e-2 rad modulo
# 2 pi in at least 99.9 % of the pixels; the batch PSNR within 0.3 dB of the
# JAX package's, the fast gate's rule. Measured on a CPU: amp_foc 1.3e-2
# (stacks off) and 8.6e-3 (on), distance 3.9e-3 and 2.0e-3, every pixel
# within 3e-2 rad, PSNR 0.005 and 0.012 dB apart.
INT8_AMP_TOL = 2e-2
INT8_DIST_TOL = 1e-2
INT8_PHASE_TOL = 3e-2
INT8_PHASE_FRACTION = 0.999


@pytest.fixture(scope="module")
def flagship_int8(flagship):
    """The JAX package's int8 outputs on golden batch 10, stacks off and on
    (one jitted run each)."""
    params, _, _ = flagship
    scales = quant.load_scales(os.path.join(REPO, "checkpoints", "quant_scales.json"))
    sm, ss = load_style_vector(os.path.join(REPO, "checkpoints", "style_vector.npz"))
    goldens = load_golden_suite()
    with open(os.path.join(REPO, "checkpoints", "config.json")) as f:
        jcfg = JConfig.from_json(f.read())
    refs = {}
    try:
        for mode in ("off", "on"):
            jquant.set_fused_stacks(mode)
            fn = jfr.make_retrieval_fn(jcfg.physics, width=jcfg.model.width, quant_scales=scales)
            out = fn(params, jnp.asarray(goldens.content_holo[10]), jnp.asarray(sm),
                     jnp.asarray(ss), goldens.distance_style[10])
            refs[mode] = {k: np.asarray(v) for k, v in out.items()}
    finally:
        jquant.set_fused_stacks("off")
    return scales, (sm, ss), goldens, refs


@pytest.mark.parametrize("mode", ["off", "on"])
def test_flagship_int8_path_matches_jax_on_golden_batch_10(flagship, flagship_int8, mode):
    _, net, cfg = flagship
    scales, (sm, ss), goldens, refs = flagship_int8
    ref = refs[mode]
    quant.set_fused_stacks(mode)
    try:
        got = make_retrieval_fn(cfg.physics, quant_scales=scales, device="cpu")(
            net, goldens.content_holo[10], sm, ss, goldens.distance_style[10]
        )
    finally:
        quant.set_fused_stacks("off")
    for key in ref:
        assert got[key].dtype == torch.float32 and tuple(got[key].shape) == ref[key].shape, key

    amp_err = _rel(got["amp_foc"].numpy(), ref["amp_foc"])
    dist_err = np.abs(got["distance_pred"].numpy() - ref["distance_pred"]).max()
    zm = lambda x: x - x.mean(axis=(-2, -1), keepdims=True)  # noqa: E731
    dph = zm(got["ph_foc"].numpy()) - zm(ref["ph_foc"])
    wrapped = np.abs(np.mod(dph + math.pi, 2 * math.pi) - math.pi)
    within = (wrapped < INT8_PHASE_TOL).mean()
    gt = tmetrics.zero_mean(torch.as_tensor(goldens.gt_phase[10]))
    psnr_port = float(tmetrics.psnr(tmetrics.zero_mean(got["ph_foc"]), gt))
    psnr_jax = float(tmetrics.psnr(tmetrics.zero_mean(torch.tensor(ref["ph_foc"])), gt))
    print(f"stacks {mode}: amp_foc {amp_err:.3g}, distance {dist_err:.3g}, "
          f"phase within {INT8_PHASE_TOL} rad {within:.6f}, PSNR {psnr_port:.5f} vs {psnr_jax:.5f}")
    assert amp_err < INT8_AMP_TOL
    assert dist_err < INT8_DIST_TOL
    assert within >= INT8_PHASE_FRACTION
    assert abs(psnr_port - psnr_jax) < 0.3
