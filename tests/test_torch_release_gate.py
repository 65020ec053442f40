"""The port held to every MNIST release of the JAX package's fast gate.

Each release of tests/test_release_fast_gate.py ``ARTIFACTS`` (the flagship,
``adv`` and the width ladder ``fast`` 0.5, ``balanced`` 0.75, ``turbo``
0.375, ``ultra`` 0.25) is restored with orbax, converted with
``convert_params`` and run by the port on the CPU; a release that is absent
skips.

* fp32, golden batch 10: the recorded ``psnr_per_batch[10]`` within 0.3 dB
  and the recorded distance predictions within 3 µm, that file's rule.
* The int8 serving path in bf16 with the release's ``quant_scales.json``,
  batch 10. No ``quant_golden_metrics.json`` records per-batch numbers, so
  the batch is held to the JAX package's int8 path on the same batch: PSNR
  within 0.3 dB (the fast gate's rule) and ``distance_pred`` within 1e-2
  (tests/test_torch_retrieval.py's int8 rule: one bf16 ulp of a distance
  near 1 is 3.9e-3), and its distances within 0.5 µm of the JAX package's
  (the bf16 distance head rounds where XLA rounds). ``adv`` has no int8
  scales.
* Marked slow, the whole 20 x 5 suite through ``evaluate_golden_suite``:
  fp32 every batch's PSNR within 0.3 dB of ``golden_metrics.json``; int8
  the mean PSNR within 0.05 dB and R² within 1e-4 of
  ``quant_golden_metrics.json`` (the limits of PERF.md, section 2).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_based_holographic_imaging_tpu.config import ExperimentConfig as JConfig
from style_transfer_based_holographic_imaging_tpu.pipelines import field_retrieval as jfr
from style_transfer_based_holographic_imaging_tpu_torch import ExperimentConfig
from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite
from style_transfer_based_holographic_imaging_tpu_torch.eval import metrics as tmetrics
from style_transfer_based_holographic_imaging_tpu_torch.interop import (
    convert_params,
    load_style_vector,
)
from style_transfer_based_holographic_imaging_tpu_torch.models import (
    StyleTransferNet,
    has_phase_decoder,
    quant,
)
from style_transfer_based_holographic_imaging_tpu_torch.pipelines import (
    evaluate_golden_suite,
    make_retrieval_fn,
)
from test_release_fast_gate import ARTIFACTS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 10
IDS = [a[0] for a in ARTIFACTS]
_cache = {}


def _release(name):
    """(params, net, cfg, config text, style vector, recorded metrics, int8
    scales or None, recorded int8 metrics or None) of a release, once."""
    if name not in _cache:
        _, release, style, config, recorded = next(a for a in ARTIFACTS if a[0] == name)
        path = lambda p: os.path.join(REPO, p)  # noqa: E731
        if not os.path.isdir(path(release)):
            pytest.skip(f"no {name} release promoted")
        ocp = pytest.importorskip("orbax.checkpoint")
        params = ocp.StandardCheckpointer().restore(path(release))["params"]
        with open(path(config)) as f:
            text = f.read()
        cfg = ExperimentConfig.from_json(text)
        net = StyleTransferNet(width=cfg.model.width, with_phase_decoder=has_phase_decoder(params))
        net.load_state_dict(convert_params(params), strict=True)
        with open(path(recorded)) as f:
            rec = json.load(f)
        scales_path = path(recorded.replace("golden_metrics.json", "quant_scales.json"))
        quant_path = path(recorded.replace("golden_metrics.json", "quant_golden_metrics.json"))
        scales = quant.load_scales(scales_path) if os.path.isfile(scales_path) else None
        quant_rec = None
        if os.path.isfile(quant_path):
            with open(quant_path) as f:
                quant_rec = json.load(f)
        _cache[name] = (params, net.eval(), cfg, text, load_style_vector(path(style)), rec,
                        scales, quant_rec)
    return _cache[name]


def _batch_psnr(ph_foc, goldens):
    gt = tmetrics.zero_mean(torch.as_tensor(goldens.gt_phase[BATCH]))
    return float(tmetrics.psnr(tmetrics.zero_mean(torch.as_tensor(ph_foc)), gt))


@pytest.mark.parametrize("name", IDS)
def test_port_reproduces_recorded_batch_metrics(name):
    _, net, cfg, _, (sm, ss), rec, _, _ = _release(name)
    goldens = load_golden_suite()
    out = make_retrieval_fn(cfg.physics, alpha=cfg.eval.alpha, device="cpu")(
        net, goldens.content_holo[BATCH], sm, ss, goldens.distance_style[BATCH]
    )
    got = _batch_psnr(out["ph_foc"], goldens)
    want = rec["psnr_per_batch"][BATCH]
    assert abs(got - want) < 0.3, f"{name}: batch {BATCH} PSNR {got:.4f} dB vs recorded {want:.4f}"
    b = goldens.batch_size
    um = tmetrics.distances_to_um(out["distance_pred"].numpy().reshape(-1), cfg.physics)
    np.testing.assert_allclose(um, rec["distance_pred_um"][BATCH * b : BATCH * b + b], atol=3.0)


def _int8_batch(name):
    """(port output, JAX output) of the int8 path on batch BATCH, once."""
    key = ("int8", name)
    if key not in _cache:
        params, net, cfg, text, (sm, ss), _, scales, _ = _release(name)
        if scales is None:
            pytest.skip(f"{name} has no quant_scales.json")
        goldens = load_golden_suite()
        jcfg = JConfig.from_json(text)
        ref = jfr.make_retrieval_fn(
            jcfg.physics, alpha=jcfg.eval.alpha, width=jcfg.model.width,
            with_phase_decoder=has_phase_decoder(params), quant_scales=scales,
        )(params, jnp.asarray(goldens.content_holo[BATCH]), jnp.asarray(sm), jnp.asarray(ss),
          goldens.distance_style[BATCH])
        got = make_retrieval_fn(cfg.physics, alpha=cfg.eval.alpha, quant_scales=scales, device="cpu")(
            net, goldens.content_holo[BATCH], sm, ss, goldens.distance_style[BATCH]
        )
        _cache[key] = (got, ref)
    return _cache[key]


@pytest.mark.parametrize("name", IDS)
def test_port_int8_batch_matches_jax(name):
    got, ref = _int8_batch(name)
    goldens = load_golden_suite()
    psnr_port = _batch_psnr(got["ph_foc"], goldens)
    psnr_jax = _batch_psnr(np.array(ref["ph_foc"]), goldens)
    assert abs(psnr_port - psnr_jax) < 0.3, f"{name}: int8 PSNR {psnr_port:.4f} vs JAX {psnr_jax:.4f}"
    dist_err = np.abs(got["distance_pred"].numpy() - np.asarray(ref["distance_pred"])).max()
    assert dist_err < 1e-2


@pytest.mark.parametrize("name", IDS)
def test_port_int8_distances_equal_jax(name):
    """The int8 path's distance head rounds its bf16 steps where XLA does, so
    the predicted distances are the JAX package's on the same CPU: within
    0.5 µm, below the one bf16 ulp (3.9 µm near 0.7 mm on ``balanced``) by
    which eager per-op rounding missed them."""
    got, ref = _int8_batch(name)
    physics = _release(name)[2].physics
    um = lambda d: tmetrics.distances_to_um(np.asarray(d).reshape(-1), physics)  # noqa: E731
    err = np.abs(um(got["distance_pred"].numpy()) - um(np.array(ref["distance_pred"], np.float32)))
    assert err.max() < 0.5, f"{name}: int8 distances up to {err.max():.3f} µm from the JAX package's"


@pytest.mark.slow
@pytest.mark.parametrize("path", ["fp32", "int8"])
@pytest.mark.parametrize("name", IDS)
def test_port_reproduces_recorded_suite_metrics(name, path):
    _, net, cfg, _, style, rec, scales, quant_rec = _release(name)
    if path == "int8" and (scales is None or quant_rec is None):
        pytest.skip(f"{name} has no int8 scales or metrics")
    got = evaluate_golden_suite(
        net, load_golden_suite(), cfg, style_override=style, device="cpu",
        quant_scales=scales if path == "int8" else None,
        dtype=torch.bfloat16 if path == "int8" else None,
    )
    if path == "fp32":
        diff = np.abs(np.asarray(got["psnr_per_batch"]) - np.asarray(rec["psnr_per_batch"]))
        assert diff.max() < 0.3, f"{name}: batch PSNR up to {diff.max():.4f} dB from recorded"
    else:
        assert abs(got["mean_psnr"] - quant_rec["mean_psnr"]) < 0.05
        assert abs(got["r2"] - quant_rec["r2"]) < 1e-4, f"{name}: int8 R² {got['r2']} vs {quant_rec['r2']}"
