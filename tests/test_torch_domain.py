"""The experimental domains on the port against the JAX package: the presets,
the synthetic object banks, ``coral``, the style vector and the domain
releases' scoring (``pipelines/domain_eval.py``).

* ``DOMAIN_PRESETS``: every alias gives the JAX package's config, field for
  field (the port's dataclasses carry a subset of the JAX fields: the
  discriminator's shape and ``dp_axis`` are not ported).
* ``bead_bank`` and ``rbc_bank``: bit for bit.
* ``coral``: within 1e-5 of max (an fp32 SVD and inverse on each side).
* ``extract_style_vector`` at width 0.25 on the same weights (the ``ultra``
  release's), two batches of the JAX stream (MNIST physics, 64^2): within
  1e-5 of max.
* ``evaluate_synth_domain`` on the ``rbc`` and ``bead`` releases (their
  orbax weights restored and converted on the CPU; ``bead`` was saved on a
  TPU and restores into ``rbc``'s tree, the same architecture, as the JAX
  package's ``load_release_params`` restores it into a fresh one), one batch of 32 of the
  records' protocol (stream seed 7777, bank seed 7919): PSNR within 0.005 dB
  of the JAX package's, every distance within 0.5 µm. The same batch
  refined for 3 steps with the distance (``refine_distance``): PSNR within
  0.005 dB of the JAX package's. Its refined distances are not compared
  sample by sample: Adam moves each by about its step size against its
  gradient's sign, and the two packages' gradients in the distance differ
  by up to 4.5 % (rbc) and 13.4 % (bead) of the largest, enough to flip a
  step's sign near the optimum (the refined distances part by up to 25.5
  and 282.5 µm): the fp32 rounding of the global phasor's term, zero in
  exact arithmetic, which the JAX package's gradient carries about six and
  ten times as large as the port's (ROADMAP, Known differences, C.7). Held
  instead: the distance stage's first step goes against the JAX package's gradient
  wherever that agrees in sign with a central difference of the JAX
  package's loss; ``physics_refine`` runs max(3 // 2, 10) distance steps
  at the phase given, then 3 joint steps, from the net's prediction, and
  the first step of each stage is its rate (0.1 and 0.02 times ``lr``)
  times g / (|g| + 1e-8) of the port's gradient g; that gradient lies
  within 1.5e-2 of the largest off the central difference (it reads 7.4e-3
  and 1.33e-2; ``scripts/port_domain_eval.py --distance-gradient``; the
  central difference itself lies 1.7e-4 and 1.0e-2 off float64,
  ``tests/test_torch_refine_distance.py``).
* The refine loss's distance gradient at that first batch against
  ``tests/test_torch_refine_distance.py``'s float64 reference, by its
  ``hold_distance_gradients_to_float64`` (ROADMAP C.7): the port within
  1e-2 (rbc) and 2e-2 (bead) of float64's largest value, no farther than
  the JAX package, float64's sign on every sample.
* ``checkpoints/port_cpu_domain_readings.json`` (the port's CPU readings
  that ``chip_smoke.py`` holds the card to where the records cannot be
  reproduced or its time allows fewer batches, ROADMAP C.6 and C.8): its
  first fp32 batch and its first refine-distance batch (60 steps; the
  reading covers 5 batches) are the port's, and its fp32 means are the
  records'.
* ``serve --checkpoint checkpoints/rbc_release --quant auto``'s service
  (``cli.build_service``) names rbc's release, style vector and
  band-limited config in its ``loaded`` lines, and answers with rbc's
  sibling int8 scales and style vector, never the flagship's.
* Marked slow (run with ``-m ""``), the records: the 10-batch fp32 metrics,
  the int8 path's 3 batches (``*_quant_domain_metrics.json``), the
  refined metrics (200 steps for rbc, 100 for bead) and the refine-distance
  metrics (60 steps). Each mean PSNR within 0.005 dB of its record, or,
  where the JAX package on this CPU misses the record by as much, within
  0.005 dB of the JAX package (ROADMAP C.6); the refine-distance mean,
  which moves with torch's thread count, then no farther from the record
  than the JAX package's (ROADMAP C.7).
"""

import dataclasses
import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_cpu_threads import FEW_THREADS, warm_few_torch_threads  # noqa: F401
from torch_records import held_to_record_or_no_farther_than_jax
from test_torch_refine_distance import hold_distance_gradients_to_float64

from style_transfer_based_holographic_imaging_tpu.config import DOMAIN_PRESETS as J_PRESETS
from style_transfer_based_holographic_imaging_tpu.config import ExperimentConfig as JConfig
from style_transfer_based_holographic_imaging_tpu.data import synth as jsynth
from style_transfer_based_holographic_imaging_tpu.ops import stats as jstats
from style_transfer_based_holographic_imaging_tpu.pipelines import domain_eval as jdomain
from style_transfer_based_holographic_imaging_tpu.pipelines import style_vector as jstyle
from style_transfer_based_holographic_imaging_tpu_torch import cli
from style_transfer_based_holographic_imaging_tpu_torch.config import DOMAIN_PRESETS, ExperimentConfig
from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite, synth
from style_transfer_based_holographic_imaging_tpu_torch.interop import convert_params, load_style_vector
from style_transfer_based_holographic_imaging_tpu_torch.models import StyleTransferNet, quant
from style_transfer_based_holographic_imaging_tpu_torch.ops import holo_forward
from style_transfer_based_holographic_imaging_tpu_torch.ops.stats import coral
from style_transfer_based_holographic_imaging_tpu_torch.pipelines import (
    evaluate_synth_domain,
    extract_style_vector,
    make_retrieval_fn,
)
from style_transfer_based_holographic_imaging_tpu_torch.pipelines import refine as port_refine
from style_transfer_based_holographic_imaging_tpu_torch.utils import jax_random

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints")
# tag -> (preset, bank, refined steps of its record)
DOMAINS = {"rbc": ("red_blood_cell", synth.rbc_bank, 200), "bead": ("polystyrene", synth.bead_bank, 100)}
EVAL_BANK_SEED = 7919
BATCH = 32
DB_TOL = 0.005
UM_TOL = 0.5
REFINE_DISTANCE_STEPS = 60
REFINE_DISTANCE_ONE_BATCH = dict(n_batches=1, refine_steps=3, refine_distance=True)
DISTANCE_GRAD_TOL = 1.5e-2
CPU_READINGS = os.path.join(CKPT, "port_cpu_domain_readings.json")
STYLE_TOL = 1e-5
CORAL_TOL = 1e-5
NOT_PORTED = {"ModelConfig": {"disc_conv_dim", "disc_repeat_num", "disc_class_dim"}}
_cache = {}


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("alias", sorted(J_PRESETS))
def test_presets_equal_jax(alias):
    assert set(DOMAIN_PRESETS) == set(J_PRESETS)
    got, want = DOMAIN_PRESETS[alias](), J_PRESETS[alias]()
    assert got.name == want.name
    for part in ("physics", "model", "data", "train", "eval"):
        g, w = getattr(got, part), getattr(want, part)
        gf, wf = _fields(g), _fields(w)
        assert set(wf) - set(gf) == NOT_PORTED.get(type(w).__name__, set()), part
        assert gf == {k: wf[k] for k in gf}, part
    # and the JSON a run writes loads back the same
    assert ExperimentConfig.from_json(want.to_json()) == got


@pytest.mark.parametrize("kw", [{}, {"n": 16, "size": 32, "seed": EVAL_BANK_SEED},
                                {"n": 8, "size": 48, "seed": 3}])
def test_banks_equal_jax(kw):
    for name in ("bead_bank", "rbc_bank"):
        got, want = getattr(synth, name)(**kw), getattr(jsynth, name)(**kw)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes(), name


@pytest.mark.parametrize("c,h", [(3, 8), (16, 12), (64, 16)])
def test_coral_matches_jax(c, h):
    rng = np.random.default_rng(c)
    src = rng.standard_normal((c, h, h)).astype(np.float32)
    tgt = (2.0 * rng.standard_normal((c, h, h)) + 1.0).astype(np.float32)
    want = np.asarray(jstats.coral(jnp.asarray(src), jnp.asarray(tgt)))
    got = coral(torch.from_numpy(src), torch.from_numpy(tgt)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= CORAL_TOL * np.abs(want).max()


def _restore(path, target=None):
    import orbax.checkpoint as ocp

    return ocp.StandardCheckpointer().restore(path, target and {"params": target})["params"]


def test_extract_style_vector_matches_jax():
    params = _restore(os.path.join(CKPT, "ultra", "release"))
    net = StyleTransferNet(width=0.25)
    net.load_state_dict(convert_params(params), strict=True)
    bank = synth.golden_digit_bank(load_golden_suite(), size=32, subset=synth.GOLDEN_TRAIN_DIGITS)
    data = dict(batch_size=4, image_size=64, digit_pad=16)
    jcfg = JConfig(data=dataclasses.replace(JConfig().data, **data))
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, width=0.25))
    cfg = ExperimentConfig.from_json(jcfg.to_json())
    want = jstyle.extract_style_vector(params, jcfg, bank, n_batches=2)
    got = extract_style_vector(net.eval(), cfg, bank, n_batches=2)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, 1, 1, net.encoder.out_channels)
        assert np.abs(g - w).max() <= STYLE_TOL * np.abs(w).max()


def _release(tag):
    """(JAX params, port net, JAX config, port config, style vector, eval
    bank, record) of a domain release, once."""
    if tag not in _cache:
        preset, make_bank, _ = DOMAINS[tag]
        params = _restore(os.path.join(CKPT, f"{tag}_release"),
                          None if tag == "rbc" else _release("rbc")[0])
        net = StyleTransferNet(width=1.0)
        net.load_state_dict(convert_params(params), strict=True)
        jcfg, cfg = J_PRESETS[preset](), DOMAIN_PRESETS[preset]()
        jcfg = dataclasses.replace(jcfg, data=dataclasses.replace(jcfg.data, batch_size=BATCH))
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, batch_size=BATCH))
        with open(os.path.join(CKPT, f"{tag}_domain_metrics.json")) as f:
            record = json.load(f)
        _cache[tag] = (params, net.eval(), jcfg, cfg,
                       load_style_vector(os.path.join(CKPT, f"{tag}_style_vector.npz")),
                       make_bank(n=512, seed=EVAL_BANK_SEED), record)
    return _cache[tag]


def _compare(got, want):
    assert len(got["psnr_per_batch"]) == len(want["psnr_per_batch"])
    np.testing.assert_allclose(got["psnr_per_batch"], want["psnr_per_batch"], rtol=0, atol=DB_TOL)
    np.testing.assert_allclose(got["distance_true_um"], want["distance_true_um"], rtol=0, atol=UM_TOL)
    np.testing.assert_allclose(got["distance_pred_um"], want["distance_pred_um"], rtol=0, atol=UM_TOL)


def _port_one_batch(tag):
    """The port's first fp32 batch of a domain release, once."""
    key = ("one_batch", tag)
    if key not in _cache:
        _, net, _, cfg, style, bank, _ = _release(tag)
        _cache[key] = evaluate_synth_domain(net, cfg, bank, style, n_batches=1, device="cpu")
    return _cache[key]


@pytest.mark.parametrize("tag", sorted(DOMAINS))
def test_domain_release_one_batch_matches_jax(tag):
    params, net, jcfg, cfg, style, bank, record = _release(tag)
    got = _port_one_batch(tag)
    want = jdomain.evaluate_synth_domain(params, jcfg, bank, style, n_batches=1)
    _compare(got, want)
    assert got["n_samples"] == BATCH and got["synthetic_eval"]
    # the stream is the record's: its first batch's distances
    np.testing.assert_allclose(got["distance_true_um"], record["distance_true_um"][:BATCH], atol=1e-3)


def _port_domain_eval():
    spec = importlib.util.spec_from_file_location("port_domain_eval",
                                                  os.path.join(REPO, "scripts", "port_domain_eval.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _port_refine_distance_batch(tag):
    """The port's first batch refined for 3 steps with the distance, once:
    (its metrics, the distance (network units) and phase that each of
    ``physics_refine``'s calls of ``holo_forward`` was given)."""
    key = ("refine_distance", tag)
    if key not in _cache:
        _, net, _, cfg, style, bank, _ = _release(tag)
        seen = []

        def recording(amp, phase, d, *args, **kwargs):
            seen.append((d.detach().reshape(-1).numpy().copy(), phase.detach().clone()))
            return holo_forward(amp, phase, d, *args, **kwargs)

        port_refine.holo_forward = recording
        try:
            got = evaluate_synth_domain(net, cfg, bank, style, device="cpu", **REFINE_DISTANCE_ONE_BATCH)
        finally:
            port_refine.holo_forward = holo_forward
        _cache[key] = got, seen
    return _cache[key]


def _distance_stage(tag):
    """``scripts/port_domain_eval.py``'s ``distance_stage_inputs`` on the
    release's first batch, once: (the known amplitude, the net's phase and
    distances, the measured amplitude)."""
    key = ("distance_stage", tag)
    if key not in _cache:
        _, net, _, cfg, style, bank, _ = _release(tag)
        _cache[key] = _port_domain_eval().distance_stage_inputs(net, cfg, bank, style)
    return _cache[key]


def _distance_gradients(tag):
    """``scripts/port_domain_eval.py``'s ``distance_gradients`` on the
    release's first batch, once: (the port's, the JAX package's, a central
    difference of the JAX package's loss, the net's distances), each (B,)."""
    key = ("distance_gradients", tag)
    if key not in _cache:
        _, _, jcfg, cfg, _, _, _ = _release(tag)
        inputs = _distance_stage(tag)
        _cache[key] = (*_port_domain_eval().distance_gradients_at(inputs, cfg.physics, jcfg.physics),
                       inputs[2].ravel())
    return _cache[key]


@pytest.mark.parametrize("tag", sorted(DOMAINS))
def test_domain_release_refine_distance_one_batch_matches_jax(tag):
    params, _, jcfg, _, style, bank, _ = _release(tag)
    got, seen = _port_refine_distance_batch(tag)
    want = jdomain.evaluate_synth_domain(params, jcfg, bank, style, **REFINE_DISTANCE_ONE_BATCH)
    np.testing.assert_allclose(got["psnr_per_batch"], want["psnr_per_batch"], rtol=0, atol=DB_TOL)
    np.testing.assert_allclose(got["distance_true_um"], want["distance_true_um"], rtol=0, atol=UM_TOL)
    # The first distance step goes against the JAX package's gradient
    # wherever that agrees in sign with the central difference of its own
    # loss (ROADMAP C.7): all of rbc's 32 samples, 31 of bead's.
    _, jax_grad, diff, _ = _distance_gradients(tag)
    agree = np.sign(jax_grad) == np.sign(diff)
    assert agree.sum() >= BATCH - 2
    np.testing.assert_array_equal(np.sign(seen[1][0] - seen[0][0])[agree], -np.sign(jax_grad)[agree])


@pytest.mark.parametrize("tag", sorted(DOMAINS))
def test_refine_distance_steps_from_the_nets_prediction(tag):
    """``physics_refine`` with the distance on a domain batch: max(3 // 2,
    10) distance steps at the phase given, then 3 joint steps and the
    residual; from the net's prediction; Adam's first step of each stage is
    its rate (``lr`` 0.1 and 0.02 times ``refine_lr``) times
    g / (|g| + 1e-8), g the loss's gradient in the distance."""
    got, seen = _port_refine_distance_batch(tag)
    lr, physics = 0.05, _release(tag)[3].physics
    assert len(seen) == 10 + 3 + 1
    d = [x for x, _ in seen]
    phase0 = seen[0][1]
    assert all(torch.equal(p, phase0) for _, p in seen[:11]) and not torch.equal(seen[11][1], phase0)
    um = lambda x: np.asarray(physics.to_metres(x), np.float64) * 1e6  # noqa: E731
    np.testing.assert_allclose(um(d[0]), _port_one_batch(tag)["distance_pred_um"], rtol=0, atol=1e-2)
    np.testing.assert_allclose(um(d[-1]), got["distance_pred_um"], rtol=0, atol=1e-2)
    grad = _distance_gradients(tag)[0].astype(np.float64)
    np.testing.assert_allclose(d[1] - d[0], -0.1 * lr * grad / (np.abs(grad) + 1e-8), rtol=0, atol=1e-6)
    joint = np.abs(d[11] - d[10])
    assert joint.max() <= 0.02 * lr * (1 + 1e-3) and np.median(joint) > 0.02 * lr * 0.99


@pytest.mark.parametrize("tag", sorted(DOMAINS))
def test_refine_distance_gradient_matches_a_central_difference_of_the_jax_loss(tag):
    port, _, diff, _ = _distance_gradients(tag)
    assert port.shape == diff.shape == (BATCH,)
    assert np.abs(port - diff).max() < DISTANCE_GRAD_TOL * np.abs(diff).max()


@pytest.mark.parametrize("tag", sorted(DOMAINS))
def test_refine_distance_gradient_against_float64(tag):
    """ROADMAP C.7 on the domain releases (band-limited: the card's refine
    takes ``propagate_torch``'s autograd too), by
    ``tests/test_torch_refine_distance.py``'s float64 reference and rule."""
    port, jax_grad, diff, _ = _distance_gradients(tag)
    hold_distance_gradients_to_float64(tag, _distance_stage(tag), _release(tag)[3].physics, port, jax_grad, diff)


@pytest.mark.parametrize("path", ["fp32", "refine_distance"])
@pytest.mark.parametrize("tag", sorted(DOMAINS))
def test_cpu_readings_hold_the_ports_first_batch(tag, path):
    with open(CPU_READINGS) as f:
        reading = json.load(f)[tag][path]
    _, net, _, cfg, style, bank, record = _release(tag)
    if path == "fp32":
        n = len(record["psnr_per_batch"])
        got = _port_one_batch(tag)
    else:  # the batches chip_smoke.py refines so, at the record's steps
        n = 5
        assert record["refine_distance_steps"] == REFINE_DISTANCE_STEPS
        # at this module's torch threads: the refine with the distance depends on them (ROADMAP C.7)
        assert (f"--batches {n} --refine-steps {REFINE_DISTANCE_STEPS} --refine-distance --threads {FEW_THREADS}"
                in reading["command"])
        got = evaluate_synth_domain(net, cfg, bank, style, n_batches=1, refine_steps=REFINE_DISTANCE_STEPS,
                                    refine_distance=True, device="cpu")
    assert reading["batches"] == n and len(reading["psnr_per_batch"]) == n
    assert len(reading["distance_pred_um"]) == n * BATCH
    np.testing.assert_allclose(got["psnr_per_batch"], reading["psnr_per_batch"][:1], rtol=0, atol=DB_TOL)
    np.testing.assert_allclose(got["distance_pred_um"], reading["distance_pred_um"][:BATCH], rtol=0, atol=UM_TOL)
    if path == "fp32":
        # the records' means and R² are the port's; their per-batch arrays are another run's (ROADMAP C.8)
        assert abs(reading["mean_psnr"] - record["mean_psnr"]) < DB_TOL
        assert abs(reading["r2"] - record["r2"]) < 1e-4


def test_serve_on_a_domain_release_loads_its_siblings(capsys):
    """``serve --checkpoint checkpoints/rbc_release --quant auto``'s service
    names rbc's release, style vector and config in its ``loaded`` lines,
    and answers with rbc's int8 scales and style vector: the flagship's
    scales, or its style vector, each answer otherwise."""
    release = os.path.join(CKPT, "rbc_release")
    args = cli.build_parser().parse_args(["serve", "--cpu", "--checkpoint", release, "--quant", "auto",
                                          "--batch-size", "2"])
    service = cli.build_service(args)
    err = capsys.readouterr().err
    for line in (f"loaded checkpoint {release}", f"loaded style vector {os.path.join(CKPT, 'rbc_style_vector.npz')}",
                 f"loaded run config {os.path.join(CKPT, 'rbc_config.json')}"):
        assert line in err
    with open(os.path.join(CKPT, "rbc_config.json")) as f:
        cfg = ExperimentConfig.from_json(f.read())
    assert service.config == cfg and service.config.physics.band_limit
    assert service.health()["quantized"] and service.device == torch.device("cpu")
    want = _release("rbc")[1].state_dict()
    assert all(torch.equal(v, want[k]) for k, v in service.net.state_dict().items())

    _, _, _, _, style, bank, _ = _release("rbc")
    batch = synth.synth_batch_from_key(jax_random.fold_in(jax_random.key(7777), 0),
                                       torch.as_tensor(bank), cfg.data, cfg.physics)
    holo = (batch["content_holo"][:2] ** 2).numpy()
    got = service.retrieve(holo)
    d_style = float(cfg.physics.to_network_units(cfg.data.style_distances[0]))
    flagship_style = load_style_vector(os.path.join(CKPT, "style_vector.npz"))
    for scales, sv, same in (("rbc_quant_scales.json", style, True), ("quant_scales.json", style, False),
                             ("rbc_quant_scales.json", flagship_style, False)):
        fn = make_retrieval_fn(cfg.physics, alpha=cfg.eval.alpha, dtype=torch.bfloat16, device="cpu",
                               quant_scales=quant.load_scales(os.path.join(CKPT, scales)))
        with torch.no_grad():
            out = fn(service.net, torch.from_numpy(holo), *(torch.as_tensor(np.asarray(v)) for v in sv), d_style)
        equal = all(np.array_equal(got[k], out[k].float().numpy()) for k in got)
        assert equal == same, (scales, same)


def _held_to_record(got_db, record_db, jax_run):
    """Within DB_TOL of the record, or the JAX package misses it alike."""
    if abs(got_db - record_db) < DB_TOL:
        return
    want = jax_run()
    assert abs(want - record_db) >= DB_TOL, (
        f"the port {got_db:.5f} dB misses the record {record_db:.5f}, the JAX package "
        f"{want:.5f} gives it")
    assert abs(got_db - want) < DB_TOL, (got_db, want, record_db)


@pytest.mark.slow
@pytest.mark.parametrize("tag", sorted(DOMAINS))
def test_domain_release_reproduces_fp32_record(tag):
    params, net, jcfg, cfg, style, bank, record = _release(tag)
    n = len(record["psnr_per_batch"])
    got = evaluate_synth_domain(net, cfg, bank, style, n_batches=n, device="cpu")
    _held_to_record(got["mean_psnr"], record["mean_psnr"],
                    lambda: jdomain.evaluate_synth_domain(params, jcfg, bank, style, n_batches=n)["mean_psnr"])
    np.testing.assert_allclose(got["distance_true_um"], record["distance_true_um"], atol=1e-3)


@pytest.mark.slow
@pytest.mark.parametrize("tag", sorted(DOMAINS))
def test_domain_release_reproduces_int8_record(tag):
    params, net, jcfg, cfg, style, bank, _ = _release(tag)
    with open(os.path.join(CKPT, f"{tag}_quant_domain_metrics.json")) as f:
        record = json.load(f)
    scales = quant.load_scales(os.path.join(CKPT, f"{tag}_quant_scales.json"))
    n = record["n_batches"]
    got = evaluate_synth_domain(net, cfg, bank, style, n_batches=n, quant_scales=scales,
                                dtype=torch.bfloat16, device="cpu")
    _held_to_record(got["mean_psnr"], record["mean_psnr"], lambda: jdomain.evaluate_synth_domain(
        params, jcfg, bank, style, n_batches=n, quant_scales=scales, dtype=jnp.bfloat16)["mean_psnr"])
    fp = evaluate_synth_domain(net, cfg, bank, style, n_batches=n, device="cpu")
    _held_to_record(fp["mean_psnr"], record["fp_same_subset"]["mean_psnr"],
                    lambda: jdomain.evaluate_synth_domain(params, jcfg, bank, style, n_batches=n)["mean_psnr"])


@pytest.mark.slow
@pytest.mark.parametrize("tag", sorted(DOMAINS))
def test_domain_release_reproduces_refined_record(tag):
    params, net, jcfg, cfg, style, bank, record = _release(tag)
    steps = DOMAINS[tag][2]
    assert record["refined_steps"] == steps
    n = len(record["psnr_per_batch"])
    got = evaluate_synth_domain(net, cfg, bank, style, n_batches=n, refine_steps=steps, device="cpu")
    _held_to_record(got["mean_psnr"], record["refined_mean_psnr"], lambda: jdomain.evaluate_synth_domain(
        params, jcfg, bank, style, n_batches=n, refine_steps=steps)["mean_psnr"])


@pytest.mark.slow
@pytest.mark.parametrize("tag", sorted(DOMAINS))
def test_domain_release_reproduces_refine_distance_record(tag):
    params, net, jcfg, cfg, style, bank, record = _release(tag)
    assert record["refine_distance_steps"] == REFINE_DISTANCE_STEPS
    n = len(record["psnr_per_batch"])
    kw = dict(n_batches=n, refine_steps=REFINE_DISTANCE_STEPS, refine_distance=True)
    got = evaluate_synth_domain(net, cfg, bank, style, device="cpu", **kw)
    held_to_record_or_no_farther_than_jax(got["mean_psnr"], record["refine_distance_mean_psnr"],
                                          lambda: jdomain.evaluate_synth_domain(params, jcfg, bank, style,
                                                                                **kw)["mean_psnr"], DB_TOL)
