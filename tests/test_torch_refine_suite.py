"""The golden suite's refine option, autofocus and the flagship release
refined, in the port against the JAX package (the ASM ops' gradients,
``tv_loss`` and ``physics_refine`` itself: ``tests/test_torch_refine.py``).

The same seeded numpy inputs go through both packages on the CPU.

* ``evaluate_golden_suite(..., refine_steps=5)`` on a narrow seeded net, two
  batches, with and without ``refine_distance``: per-batch PSNR within 0.05
  dB and the distances within 0.5 um of the JAX package's;
  ``refine_steps=0`` the unrefined metrics exactly.
* (d) ``autofocus`` against the JAX function on tests/test_autofocus.py's
  digits: the same candidate for every metric, the same coarse grid; the
  sharpness metrics within 1e-5.
* (e) The flagship release converted with ``interop.convert_params``,
  golden batches 0 and 10 at 100 steps: refined PSNR within 0.3 dB of the
  JAX package per batch; ``refine_distance`` at 40 steps gives R² > 0.995
  (tests/test_release_checkpoint.py's bar).
* (f) ``slow``: the whole refined suite (100 steps) within 0.05 dB of the
  recorded ``refined_mean_psnr`` and ``refined_heldout_mean_psnr``.

torch runs at two threads here (``tests/torch_cpu_threads.py``).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_cpu_threads import warm_few_torch_threads  # noqa: F401

from style_transfer_based_holographic_imaging_tpu.config import ExperimentConfig as JConfig
from style_transfer_based_holographic_imaging_tpu.pipelines import field_retrieval as jfr
from style_transfer_based_holographic_imaging_tpu.pipelines.autofocus import (
    autofocus as j_autofocus,
)
from style_transfer_based_holographic_imaging_tpu.pipelines.autofocus import (
    sharpness as j_sharpness,
)
from style_transfer_based_holographic_imaging_tpu.pipelines.refine import physics_refine as j_refine
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
)
from style_transfer_based_holographic_imaging_tpu_torch.ops import holo_forward
from style_transfer_based_holographic_imaging_tpu_torch.pipelines import (
    autofocus,
    evaluate_golden_suite,
    make_retrieval_fn,
    physics_refine,
    sharpness,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "checkpoints", "config.json")) as _f:
    CONFIG_TEXT = _f.read()
CFG = ExperimentConfig.from_json(CONFIG_TEXT)
JCFG = JConfig.from_json(CONFIG_TEXT)


def _psnr(ph, gt):
    return float(tmetrics.psnr(tmetrics.zero_mean(torch.tensor(np.asarray(ph))),
                               tmetrics.zero_mean(torch.tensor(gt))))


# --------------------------------------------------------------------------
# The golden suite's refine option
# --------------------------------------------------------------------------


@pytest.mark.parametrize("refine_distance", [False, True])
def test_evaluate_golden_suite_refines_as_the_jax_package(refine_distance):
    """The suite's refine option on a narrow seeded net, two batches, a few
    steps: per-batch PSNR and the reported distances against the JAX
    package's, and ``refine_steps=0`` the unrefined metrics exactly."""
    from style_transfer_based_holographic_imaging_tpu.config import ModelConfig as JModelConfig
    from style_transfer_based_holographic_imaging_tpu.data import load_golden_suite as j_goldens
    from style_transfer_based_holographic_imaging_tpu.models.net import init_net_params
    from style_transfer_based_holographic_imaging_tpu_torch import ModelConfig

    width = 0.125
    init = jax.jit(lambda key: init_net_params(key, image_size=128, width=width))
    params = jax.device_get(init(jax.random.key(0)))
    net = StyleTransferNet(width=width)
    net.load_state_dict(convert_params(params), strict=True)
    net.eval()
    rng = np.random.default_rng(0)
    sm = rng.random((1, 1, 1, 64)).astype(np.float32)
    ss = (0.5 + rng.random((1, 1, 1, 64))).astype(np.float32)
    cfg = dataclasses.replace(CFG, model=ModelConfig(width=width))
    jcfg = dataclasses.replace(JCFG, model=JModelConfig(width=width))
    kw = dict(refine_steps=5, refine_distance=refine_distance)
    goldens = load_golden_suite().subset(2)
    got = evaluate_golden_suite(net, goldens, cfg, style_override=(sm, ss), device="cpu", **kw)
    ref = jfr.evaluate_golden_suite(params, j_goldens().subset(2), jcfg,
                                    style_override=(jnp.asarray(sm), jnp.asarray(ss)), **kw)
    np.testing.assert_allclose(got["psnr_per_batch"], ref["psnr_per_batch"], atol=0.05)
    np.testing.assert_allclose(got["distance_pred_um"], ref["distance_pred_um"], atol=0.5)
    plain = evaluate_golden_suite(net, goldens, cfg, style_override=(sm, ss), device="cpu")
    assert plain == evaluate_golden_suite(net, goldens, cfg, style_override=(sm, ss),
                                          device="cpu", refine_steps=0)
    assert (plain["distance_pred_um"] == got["distance_pred_um"]) != refine_distance


# --------------------------------------------------------------------------
# (d) autofocus
# --------------------------------------------------------------------------

AUTOFOCUS_CASES = {
    # name: (object amplitude, phase, true distance(s), n_coarse, n_fine, metric),
    # the cases of tests/test_autofocus.py
    "tamura": ("phase", slice(0, 1), 0.6, 33, 17, "tamura"),
    "tamura_batched": ("phase", slice(0, 2), [0.4, 0.8], 33, 9, "tamura"),
    "grad": ("amplitude", slice(0, 1), 0.5, 33, 9, "grad"),
    "sparsity": ("amplitude", slice(1, 2), 0.5, 33, 9, "sparsity"),
}


@pytest.mark.parametrize("case", sorted(AUTOFOCUS_CASES))
def test_autofocus_picks_the_jax_candidate(case):
    kind, sl, d_true, n_coarse, n_fine, metric = AUTOFOCUS_CASES[case]
    digits = load_golden_suite().gt_phase[0][sl]
    if kind == "phase":
        amp, ph = np.full_like(digits, 0.6), digits
    else:
        amp, ph = 1.0 - 0.7 * digits, np.zeros_like(digits)
    d = np.asarray(d_true, np.float32).reshape(-1, 1, 1, 1)
    holo = holo_forward(torch.tensor(amp), torch.tensor(ph), torch.tensor(d), CFG.physics).numpy()
    kw = dict(n_coarse=n_coarse, n_fine=n_fine, metric=metric)
    got = [t.numpy() for t in autofocus(holo, 0.2, 1.0, CFG.physics, device="cpu", **kw)]
    ref = [np.asarray(t) for t in j_autofocus(jnp.asarray(holo), 0.2, 1.0, JCFG.physics, **kw)]
    np.testing.assert_array_equal(got[2], ref[2])  # the coarse grid
    np.testing.assert_array_equal(got[0], ref[0])  # the chosen candidates
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-4)
    assert np.abs(got[0] - d.reshape(-1)).max() < 0.06


@pytest.mark.parametrize("metric", ["tamura", "grad", "sparsity"])
def test_sharpness_matches_jax(metric):
    rng = np.random.default_rng(1)
    f = (rng.random((3, 1, 32, 32)) + 1j * rng.random((3, 1, 32, 32))).astype(np.complex64)
    got = sharpness(torch.tensor(f), metric).numpy()
    ref = np.asarray(j_sharpness(jnp.asarray(f), metric))
    np.testing.assert_allclose(got, ref, rtol=1e-5)


# --------------------------------------------------------------------------
# (e), (f) the flagship release
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def flagship():
    ocp = pytest.importorskip("orbax.checkpoint")
    params = ocp.StandardCheckpointer().restore(os.path.join(REPO, "checkpoints", "release"))["params"]
    net = StyleTransferNet(width=CFG.model.width, with_phase_decoder=has_phase_decoder(params))
    net.load_state_dict(convert_params(params), strict=True)
    style = load_style_vector(os.path.join(REPO, "checkpoints", "style_vector.npz"))
    return params, net.eval(), style


def _refined_batch(flagship, i, steps, refine_distance):
    """(port, JAX) refinement outputs of golden batch ``i`` from each
    package's own retrieval."""
    params, net, (sm, ss) = flagship
    g = load_golden_suite()
    holo = g.content_holo[i]
    kw = dict(steps=steps, optimize_amp=False, refine_distance=refine_distance)
    out = make_retrieval_fn(CFG.physics, device="cpu")(net, holo, sm, ss, g.distance_style[i])
    got = physics_refine(
        torch.full_like(out["amp_foc"], CFG.data.amplitude), out["ph_foc"], out["distance_pred"],
        torch.sqrt(torch.tensor(holo)), CFG.physics, device="cpu", **kw)
    jfn = jfr.make_retrieval_fn(JCFG.physics)
    jout = jfn(params, jnp.asarray(holo), jnp.asarray(sm), jnp.asarray(ss), g.distance_style[i])
    ref = j_refine(jnp.full_like(jout["amp_foc"], JCFG.data.amplitude), jout["ph_foc"],
                   jout["distance_pred"], jnp.sqrt(jnp.asarray(holo)), JCFG.physics, **kw)
    return got, ref, g


@pytest.mark.parametrize("batch", [0, 10])
def test_flagship_refined_batch_matches_jax(flagship, batch):
    got, ref, g = _refined_batch(flagship, batch, 100, False)
    gt = g.gt_phase[batch]
    port_db, jax_db = _psnr(got["phase"].numpy(), gt), _psnr(np.asarray(ref["phase"]), gt)
    assert abs(port_db - jax_db) < 0.3, (port_db, jax_db)
    with open(os.path.join(REPO, "checkpoints", "golden_metrics.json")) as f:
        rec = json.load(f)
    # well above the unrefined batch (the release's network-only PSNR)
    assert port_db > rec["psnr_per_batch"][batch] + 5.0


def test_flagship_refine_distance_recovers_the_distances(flagship):
    trues, preds = [], []
    for i in (0, 10):
        got, _, g = _refined_batch(flagship, i, 40, True)
        trues.append(g.distance_content[i].reshape(-1))
        preds.append(got["distance"].numpy().reshape(-1))
    r2 = float(tmetrics.r2_score(np.concatenate(trues), np.concatenate(preds)))
    assert r2 > 0.995, r2


@pytest.mark.slow
def test_flagship_refined_suite_reproduces_the_record(flagship):
    _, net, style = flagship
    got = evaluate_golden_suite(net, load_golden_suite(), CFG, style_override=style,
                                refine_steps=100, device="cpu")
    with open(os.path.join(REPO, "checkpoints", "golden_metrics.json")) as f:
        rec = json.load(f)
    assert abs(got["mean_psnr"] - rec["refined_mean_psnr"]) < 0.05, got["mean_psnr"]
    assert abs(got["heldout_mean_psnr"] - rec["refined_heldout_mean_psnr"]) < 0.05
