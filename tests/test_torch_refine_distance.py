"""The refine loss's gradient in the distance held to a float64 reference
(ROADMAP C.7), and the MNIST refine-distance path (``cli eval --refine N
--refine-distance``: ``evaluate_golden_suite(refine_distance=True)``) held
to the JAX package, to the port's committed CPU readings and, marked slow,
to the releases' records.

* The reference, ``float64_refine_loss``: the data term of
  ``physics_refine``'s loss written from the physics alone in float64, with
  its own replicate pad, fft2, transfer ``exp(i d kz)`` (kz from the physics
  constants in float64), the band limit's mask where the config has it,
  ifft2, the global phasor ``exp(i d 2 pi / lambda)``, crop,
  ``sqrt(clamp(|.|^2, 0))`` and the mean squared error against the measured
  amplitude (with the TV term where a phase gradient is asked for). Its
  gradients come from float64 autograd. It shares no code with either
  package.
* Where the distance stage starts (the known amplitude, the net's phase and
  distances): golden batch 0 of ``turbo`` and ``balanced`` (no band limit:
  the card's refine runs the ``asm_dynamic`` op, kernel forward and
  ``_adjoint`` backward, which ``asm_backend='cuda'`` runs here with the
  plain forward) and, through ``hold_distance_gradients_to_float64`` in
  ``tests/test_torch_domain.py`` on that file's cached stage, the first
  stream batch of ``rbc_release`` and ``bead_release`` (band-limited, so the
  port's refine runs autograd through ``propagate_torch`` on the card too).
  The port's fp32 gradient, the JAX package's ``jax.grad`` and the central
  difference of ``scripts/port_domain_eval.py`` (eps 1e-3) are each
  measured as the largest distance from float64 over the largest
  float64 value; each test prints its shares (``pytest -k float64 -rP``
  shows them). The port must lie no farther from float64 than the JAX
  package, within ``PORT_FLOAT64_SHARE``. The op's ``_adjoint`` takes the
  global phasor's term on the image, where it is zero to a rounding a
  pixel (summed over the spectrum it is FFT rounding times k0: 5.8 % of
  the largest value on turbo, 2.4 % on balanced). The op's forward is the
  plain version bit for bit, and its field's gradient does not change when
  the distance's is asked for.
* ROADMAP C.4: the per-pixel gradient in the phase of the whole refine loss
  (data and TV) at the noisy golden batch of
  ``tests/test_torch_refine.py`` (batch 10, GT + 0.3 rad, true distances),
  the port's and the JAX package's against float64.
* One golden batch of ``turbo`` refined 10 steps with the distance by both
  packages' ``physics_refine`` from the same start: PSNR within 0.005 dB of
  the JAX package's, and the distance stage's first step against the sign
  of the float64 gradient on every sample.
* ``checkpoints/port_cpu_golden_readings.json`` (the readings
  ``chip_smoke.py``'s ``narrow_releases`` phase holds the card to): the
  first batch of ``turbo``'s 240-step refine-distance reading, recomputed
  at ``FEW_THREADS`` (a refine with the distance depends on torch's thread
  count), within 0.005 dB and its distances within 0.5 µm.
* Marked slow (run with ``-m ""``), the 20-batch records: ``balanced``'s
  and ``turbo``'s ``refine_distance_mean_psnr`` and ``refine_distance_r2``
  (240 steps) and the ``refined_*`` metrics of ``balanced``, ``turbo`` and
  ``ultra`` (100 steps): within 0.05 dB and R² 1e-4 of the record, or no
  farther from it than the JAX package on this CPU where both miss.
"""

import importlib.util
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_cpu_threads import FEW_THREADS, warm_few_torch_threads  # noqa: F401
from torch_records import held_to_record_or_no_farther_than_jax

from style_transfer_based_holographic_imaging_tpu.config import ExperimentConfig as JConfig
from style_transfer_based_holographic_imaging_tpu.data import load_golden_suite as j_goldens
from style_transfer_based_holographic_imaging_tpu.ops import holo_forward as j_holo_forward
from style_transfer_based_holographic_imaging_tpu.pipelines import field_retrieval as jfr
from style_transfer_based_holographic_imaging_tpu.pipelines.refine import physics_refine as j_refine
from style_transfer_based_holographic_imaging_tpu.train.losses import tv_loss as j_tv_loss
from style_transfer_based_holographic_imaging_tpu_torch import ExperimentConfig
from style_transfer_based_holographic_imaging_tpu_torch.config import PhysicsConfig
from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite
from style_transfer_based_holographic_imaging_tpu_torch.eval import metrics as tmetrics
from style_transfer_based_holographic_imaging_tpu_torch.interop import convert_params, load_style_vector
from style_transfer_based_holographic_imaging_tpu_torch.kernels import asm_cuda
from style_transfer_based_holographic_imaging_tpu_torch.models import StyleTransferNet, has_phase_decoder
from style_transfer_based_holographic_imaging_tpu_torch.ops import holo_forward
from style_transfer_based_holographic_imaging_tpu_torch.ops.asm import propagate_torch
from style_transfer_based_holographic_imaging_tpu_torch.pipelines import (
    evaluate_golden_suite,
    make_retrieval_fn,
    physics_refine,
)
from style_transfer_based_holographic_imaging_tpu_torch.pipelines import refine as port_refine
from style_transfer_based_holographic_imaging_tpu_torch.train import tv_loss

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints")
GOLDEN = ("balanced", "turbo", "ultra")
EPS = 1e-3
TV_WEIGHT = 5e-3  # physics_refine's default
# The port's fp32 distance gradient against float64, largest error over
# the largest float64 value, at FEW_THREADS (measured: rbc 7.44e-3, bead
# 1.34e-2, turbo 6.7e-5, balanced 1.46e-4; the JAX package 4.46e-2,
# 1.34e-1, 2.22e-3, 2.05e-3). On every case the whole of either package's
# error is the global phasor's term, zero in exact arithmetic
# (scripts/port_exp_distance_gradient_terms.py). rbc and bead are held in
# tests/test_torch_domain.py, whose cached distance stage they share.
PORT_FLOAT64_SHARE = {"rbc": 1e-2, "bead": 2e-2, "turbo": 2e-4, "balanced": 3e-4}
DB_TOL = 0.005
UM_TOL = 0.5
REFINE_DISTANCE_STEPS = 240
REFINED_STEPS = 100
RECORD_DB = 0.05
RECORD_R2 = 1e-4
CPU_READINGS = os.path.join(CKPT, "port_cpu_golden_readings.json")
_cache = {}


def float64_propagate(field, d_m, physics):
    """A complex128 ``(..., H, W)`` field propagated by ``d_m`` metres
    (broadcast to the leading axes): replicate pad, fft2, ``exp(i d kz)`` with
    kz from the physics constants in float64, the band limit's mask where
    ``physics.band_limit``, ifft2, the global phasor, crop."""
    h, w = field.shape[-2:]
    pad_h, pad_w = h * (physics.pad_factor - 1) // 2, w * (physics.pad_factor - 1) // 2
    rows = torch.clamp(torch.arange(-pad_h, h + pad_h), 0, h - 1)
    cols = torch.clamp(torch.arange(-pad_w, w + pad_w), 0, w - 1)
    field = field[..., rows, :][..., cols]
    n_h, n_w = field.shape[-2:]
    fy = torch.fft.fftfreq(n_h, d=physics.pixel_size, dtype=torch.float64)
    fx = torch.fft.fftfreq(n_w, d=physics.pixel_size, dtype=torch.float64)
    inv_l = 1.0 / physics.wavelength
    kz = 2.0 * math.pi * (torch.sqrt(torch.clamp(inv_l ** 2 - fy[:, None] ** 2 - fx[None, :] ** 2, min=0.0))
                          - inv_l)
    transfer = torch.exp(1j * d_m * kz)
    if physics.band_limit:
        fy_lim = 1.0 / (physics.wavelength * torch.sqrt((2.0 * d_m.abs() / (n_h * physics.pixel_size)) ** 2 + 1.0))
        fx_lim = 1.0 / (physics.wavelength * torch.sqrt((2.0 * d_m.abs() / (n_w * physics.pixel_size)) ** 2 + 1.0))
        transfer = transfer * ((fy.abs()[:, None] <= fy_lim) & (fx.abs()[None, :] <= fx_lim))
    out = torch.fft.ifft2(transfer * torch.fft.fft2(field)) * torch.exp(1j * d_m * (2.0 * math.pi * inv_l))
    return out[..., pad_h:pad_h + h, pad_w:pad_w + w]


def float64_refine_loss(amp, phase, d, meas, physics, tv_weight=0.0):
    """``physics_refine``'s loss at (amp, phase, d) in float64 tensors:
    ``mean((|ASM(amp e^{i phase}, d)| - meas)^2) + tv_weight TV(phase) / B``,
    ``amp``, ``phase`` (network units), ``meas`` ``(B, 1, H, W)`` and ``d``
    ``(B, 1, 1, 1)`` (network units)."""
    d_m = (d + physics.distance_normalize_constant) * physics.distance_normalize * 1e-3
    ph = phase * physics.phase_normalize
    out = float64_propagate(torch.complex(amp * torch.cos(ph), amp * torch.sin(ph)), d_m, physics)
    r = torch.sqrt(torch.clamp(out.abs() ** 2, min=0.0)) - meas
    loss = torch.mean(r * r)
    if tv_weight:
        h, w = phase.shape[-2:]
        tv = ((phase[..., 1:, :] - phase[..., :-1, :]).abs().sum()
              + (phase[..., :, 1:] - phase[..., :, :-1]).abs().sum()) / h / w
        loss = loss + tv_weight * tv / phase.shape[0]
    return loss


def float64_gradients(inputs, physics, tv_weight=0.0):
    """float64 autograd of ``float64_refine_loss`` at ``inputs`` (amp,
    phase, d, meas as fp32 numpy): (the distances' (B,), the phase's)."""
    amp, phase, d, meas = (torch.tensor(np.asarray(v), dtype=torch.float64) for v in inputs)
    phase.requires_grad_(True)
    d.requires_grad_(True)
    g_d, g_phase = torch.autograd.grad(float64_refine_loss(amp, phase, d, meas, physics, tv_weight), (d, phase))
    return g_d.numpy().ravel(), g_phase.numpy()


def _share(got, ref) -> float:
    return float(np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max())


def _port_domain_eval():
    spec = importlib.util.spec_from_file_location("port_domain_eval",
                                                  os.path.join(REPO, "scripts", "port_domain_eval.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _golden(name):
    """(JAX params, port net, port config, JAX config, style vector, record)
    of an MNIST release, once."""
    if name not in _cache:
        import orbax.checkpoint as ocp

        root = os.path.join(CKPT, name)
        params = ocp.StandardCheckpointer().restore(os.path.join(root, "release"))["params"]
        with open(os.path.join(root, "config.json")) as f:
            text = f.read()
        cfg = ExperimentConfig.from_json(text)
        net = StyleTransferNet(width=cfg.model.width, with_phase_decoder=has_phase_decoder(params))
        net.load_state_dict(convert_params(params), strict=True)
        with open(os.path.join(root, "golden_metrics.json")) as f:
            record = json.load(f)
        _cache[name] = (params, net.eval(), cfg, JConfig.from_json(text),
                        load_style_vector(os.path.join(root, "style_vector.npz")), record)
    return _cache[name]


def _distance_stage(name):
    """(inputs, port physics, JAX physics) of an MNIST release, once: where
    the distance stage starts on golden batch 0 (the known amplitude, the
    net's phase in network units and distances, the measured amplitude)."""
    key = ("stage", name)
    if key not in _cache:
        _, net, cfg, jcfg, style, _ = _golden(name)
        g = load_golden_suite()
        with torch.no_grad():
            out = make_retrieval_fn(cfg.physics, alpha=cfg.eval.alpha, device="cpu")(
                net, torch.as_tensor(g.content_holo[0]), *(torch.as_tensor(np.asarray(v)) for v in style),
                g.distance_style[0])
        inputs = (np.full(out["amp_foc"].shape, cfg.data.amplitude, np.float32),
                  out["ph_foc"].numpy() / np.float32(cfg.physics.phase_normalize),
                  out["distance_pred"].numpy(), np.sqrt(g.content_holo[0]).astype(np.float32))
        _cache[key] = inputs, cfg.physics, jcfg.physics
    return _cache[key]


def hold_distance_gradients_to_float64(case, inputs, physics, port, jax_grad, central):
    """The port's (``port``), the JAX package's (``jax_grad``) and the
    central difference's (``central``) distance gradients at ``inputs``
    against float64's: prints each one's share of float64's largest value,
    and holds the port within ``PORT_FLOAT64_SHARE[case]``, no farther than
    the JAX package, and of float64's sign on every sample. Returns
    float64's gradient."""
    ref = float64_gradients(inputs, physics)[0]
    shares = {k: _share(v, ref) for k, v in (("port", port), ("jax", jax_grad), ("central", central))}
    print(json.dumps({"case": case, "share_of_float64_max": shares}))
    assert shares["port"] <= shares["jax"], shares
    assert shares["port"] < PORT_FLOAT64_SHARE[case], shares
    np.testing.assert_array_equal(np.sign(port), np.sign(ref))
    return ref


def _distance_gradients(name):
    """{port, jax, central} distance gradients of an MNIST release at its
    distance stage, once; the port's through the ``asm_dynamic`` op, the
    card's refine path (its plain forward here)."""
    key = ("gradients", name)
    if key not in _cache:
        inputs, physics, jphysics = _distance_stage(name)
        port, jgrad, central = _port_domain_eval().distance_gradients_at(
            inputs, physics, jphysics, EPS, asm_backend="cuda")
        _cache[key] = {"port": port, "jax": jgrad, "central": central}
    return _cache[key]


@pytest.mark.parametrize("name", ["turbo", "balanced"])
def test_distance_gradient_against_float64(name):
    inputs, physics, _ = _distance_stage(name)
    g = _distance_gradients(name)
    hold_distance_gradients_to_float64(name, inputs, physics, g["port"], g["jax"], g["central"])


@pytest.mark.parametrize("precision", ["high", "highest"])
def test_asm_dynamic_forward_and_field_gradient_unchanged_by_the_distance_gradient(precision):
    """The op ``asm_dynamic`` with the distance's gradient asked for: its
    forward is the plain version bit for bit, as it is with no gradient, and
    its field's gradient is bit for bit the one it gives when only the field
    asks. With the plain forward in fp32 (``highest``), the distance's
    gradient lies no farther from float64 than ``propagate_torch``
    autograd's, and within 2e-3 of max (measured 1.27e-3 and 1.2e-5), for a
    loss of the complex field (where the global phasor's term is not zero)
    and for one of ``|y|`` (where it is; autograd reads 3.3e-4 there, the
    spectral form of the phasor's term, which the op took before, 1.0e-4)."""
    rng = np.random.default_rng(3)
    b, h, w = 3, 32, 48
    physics = PhysicsConfig(wavelength=532e-9, pixel_size=1.5e-6)
    kw = dict(wavelength=physics.wavelength, pixel_size=physics.pixel_size)
    xre, xim = (torch.tensor(rng.standard_normal((b, h, w)), dtype=torch.float32) for _ in range(2))
    dist = torch.tensor([3e-4, -5e-4, 8e-4], dtype=torch.float32)
    wre, wim = (torch.tensor(rng.standard_normal((b, h, w)), dtype=torch.float32) for _ in range(2))
    plain = asm_cuda.asm_dynamic_plain(xre, xim, dist, precision=precision, **kw)

    def run(need_dist, loss):
        a, c = xre.clone().requires_grad_(True), xim.clone().requires_grad_(True)
        d = dist.clone().requires_grad_(need_dist)
        yre, yim = asm_cuda.asm_dynamic(a, c, d, precision=precision, **kw)
        grads = torch.autograd.grad(loss(yre, yim), (a, c, d) if need_dist else (a, c))
        return (yre.detach(), yim.detach()), grads

    def linear(yre, yim):
        return (yre * wre + yim * wim).sum()

    def modulus(yre, yim):
        return torch.sqrt(yre ** 2 + yim ** 2).sum()

    for loss in (linear, modulus):
        (yre, yim), (gre, gim, gd) = run(True, loss)
        assert torch.equal(yre, plain[0]) and torch.equal(yim, plain[1])
        _, (gre_only, gim_only) = run(False, loss)
        assert torch.equal(gre, gre_only) and torch.equal(gim, gim_only)
        if precision == "highest":
            d = dist.clone().requires_grad_(True)
            field = propagate_torch(torch.complex(xre, xim), d.reshape(b, 1, 1), **kw)
            (autograd,) = torch.autograd.grad(loss(field.real, field.imag), d)
            d = dist.double().requires_grad_(True)
            field = float64_propagate(torch.complex(xre.double(), xim.double()), d.reshape(b, 1, 1), physics)
            (ref,) = torch.autograd.grad(loss(field.real, field.imag), d)
            assert _share(gd, ref.numpy()) <= _share(autograd, ref.numpy()), loss.__name__
            assert _share(gd, ref.numpy()) < 2e-3, loss.__name__


def _noisy_golden_batch():
    """``tests/test_torch_refine.py``'s noisy batch: golden batch 10, its GT
    phase plus 0.3 rad of seeded noise, the true distances, the flagship's
    config."""
    g = load_golden_suite()
    with open(os.path.join(CKPT, "config.json")) as f:
        text = f.read()
    cfg = ExperimentConfig.from_json(text)
    gt = g.gt_phase[10]
    ph0 = (gt + 0.3 * np.random.default_rng(0).standard_normal(gt.shape)).astype(np.float32)
    amp = np.full_like(gt, cfg.data.amplitude)
    inputs = (amp, ph0 / np.float32(cfg.physics.phase_normalize), g.distance_content[10],
              np.sqrt(g.content_holo[10]).astype(np.float32))
    return inputs, cfg.physics, JConfig.from_json(text).physics


@pytest.mark.parametrize("point", ["start", "after_10_steps"])
def test_phase_gradient_against_float64_at_the_noisy_golden_batch(point):
    """ROADMAP C.4: how far each package's per-pixel gradient of the refine
    loss in the phase lies from float64 on the noisy batch, at the refine's
    start and at the port's phase after its 10 steps (the JAX package's
    gradient under ``jit``, as its ``lax.scan`` takes it): the largest
    error over the largest float64 value, its 99th percentile, and the
    pixels whose sign differs from float64's."""
    inputs, physics, jphysics = _noisy_golden_batch()
    amp, phase, d, meas = inputs
    if point == "after_10_steps":
        phase = physics_refine(amp, phase, d, meas, physics, steps=10, optimize_amp=False,
                               device="cpu")["phase"].numpy() / np.float32(physics.phase_normalize)
    ref = float64_gradients((amp, phase, d, meas), physics, TV_WEIGHT)[1]
    p = torch.tensor(phase, requires_grad=True)
    r = torch.sqrt(torch.clamp(holo_forward(torch.tensor(amp), p, torch.tensor(d), physics), min=0.0))
    loss = torch.mean((r - torch.tensor(meas)) ** 2) + TV_WEIGHT * tv_loss(p) / p.shape[0]
    (port,) = torch.autograd.grad(loss, p)

    def j_loss(ph):
        r = jnp.sqrt(jnp.maximum(j_holo_forward(jnp.asarray(amp), ph, jnp.asarray(d), jphysics), 0.0))
        return jnp.mean((r - jnp.asarray(meas)) ** 2) + TV_WEIGHT * j_tv_loss(ph) / ph.shape[0]

    jgrad = np.asarray(jax.jit(jax.grad(j_loss))(jnp.asarray(phase)))
    scale = np.abs(ref).max()
    readings = {}
    for name, got in (("port", port.numpy()), ("jax", jgrad)):
        err = np.abs(got.astype(np.float64) - ref) / scale
        readings[name] = (float(err.max()), float(np.percentile(err, 99)),
                          int(np.sum(np.sign(got) != np.sign(ref))))
    print(json.dumps({"point": point, "max_share_p99_share_signs_differing": readings}))
    # measured (ROADMAP C.4): at the start the port 8.58e-6 / 2.50e-6 / 1
    # pixel, the JAX package 8.53e-6 / 2.47e-6 / 1; after 10 steps 7.86e-6
    # / 2.76e-6 / 0 and 9.42e-6 / 2.77e-6 / 0
    assert max(readings["port"][0], readings["jax"][0]) < 1e-5, readings


def _psnr(phase, gt) -> float:
    """The suite's PSNR of a refined phase against the GT, both zero-meaned."""
    return float(tmetrics.psnr(tmetrics.zero_mean(torch.tensor(phase)), tmetrics.zero_mean(torch.tensor(gt))))


def _recording_refine(run):
    """``run()`` with every distance ``physics_refine`` gives ``holo_forward``
    recorded: (its result, the (B,) distances in call order)."""
    seen = []

    def recording(amp, phase, d, *args, **kwargs):
        seen.append(d.detach().reshape(-1).numpy().copy())
        return holo_forward(amp, phase, d, *args, **kwargs)

    port_refine.holo_forward = recording
    try:
        return run(), seen
    finally:
        port_refine.holo_forward = holo_forward


def test_turbo_refine_distance_one_batch_matches_jax():
    """Golden batch 0 of ``turbo`` refined 10 steps with the distance, as
    ``evaluate_golden_suite(refine_steps=10, refine_distance=True)`` refines
    it, by both packages' ``physics_refine`` from the same start (the port's
    retrieval: the known amplitude, the net's phase and distances; the two
    retrievals agree, ``tests/test_torch_release_gate.py``): the refined
    phase's PSNR against the GT within DB_TOL of the JAX package's, and the
    port's first distance step against the sign of float64's gradient on
    every sample."""
    inputs, physics, jphysics = _distance_stage("turbo")
    amp, phase, d, meas = inputs
    phase = phase * np.float32(physics.phase_normalize)
    kw = dict(steps=10, optimize_amp=False, refine_distance=True)
    got, seen = _recording_refine(lambda: physics_refine(amp, phase, d, meas, physics, device="cpu", **kw))
    want = j_refine(amp, phase, d, meas, jphysics, **kw)
    gt = load_golden_suite().gt_phase[0]
    assert abs(_psnr(got["phase"].numpy(), gt) - _psnr(np.asarray(want["phase"]), gt)) < DB_TOL
    # max(10 // 2, 10) distance steps, 10 joint steps, the residual
    assert len(seen) == 10 + 10 + 1
    np.testing.assert_array_equal(np.sign(seen[1] - seen[0]), -np.sign(float64_gradients(inputs, physics)[0]))


def test_cpu_reading_holds_the_ports_first_turbo_batch():
    with open(CPU_READINGS) as f:
        reading = json.load(f)["turbo"]["refine_distance"]
    _, net, cfg, _, style, record = _golden("turbo")
    assert record["refine_distance_steps"] == REFINE_DISTANCE_STEPS
    # chip_smoke.py refines the first 3 batches at the record's steps; the
    # reading is taken at this module's torch threads (ROADMAP C.7)
    assert reading["batches"] == 3 and reading["refine_steps"] == REFINE_DISTANCE_STEPS
    assert reading["threads"] == FEW_THREADS and f"--threads {FEW_THREADS}" in reading["command"]
    assert len(reading["psnr_per_batch"]) == 3 and len(reading["distance_pred_um"]) == 15
    got = evaluate_golden_suite(net, load_golden_suite().subset(1), cfg, style_override=style, device="cpu",
                                refine_steps=REFINE_DISTANCE_STEPS, refine_distance=True)
    np.testing.assert_allclose(got["psnr_per_batch"], reading["psnr_per_batch"][:1], rtol=0, atol=DB_TOL)
    np.testing.assert_allclose(got["distance_pred_um"], reading["distance_pred_um"][:5], rtol=0, atol=UM_TOL)


def _jax_suite(name, **kw):
    """The JAX package's whole suite of a release on this CPU, once a path."""
    key = ("jax_suite", name, tuple(sorted(kw.items())))
    if key not in _cache:
        params, _, _, jcfg, style, _ = _golden(name)
        _cache[key] = jfr.evaluate_golden_suite(
            params, j_goldens(), jcfg, style_override=(jnp.asarray(style[0]), jnp.asarray(style[1])), **kw)
    return _cache[key]


@pytest.mark.slow
@pytest.mark.parametrize("name", ["balanced", "turbo"])
def test_release_reproduces_refine_distance_record(name):
    _, net, cfg, _, style, record = _golden(name)
    assert record["refine_distance_steps"] == REFINE_DISTANCE_STEPS
    kw = dict(refine_steps=REFINE_DISTANCE_STEPS, refine_distance=True)
    got = evaluate_golden_suite(net, load_golden_suite(), cfg, style_override=style, device="cpu", **kw)
    for key, tol in (("mean_psnr", RECORD_DB), ("r2", RECORD_R2)):
        held_to_record_or_no_farther_than_jax(got[key], record[f"refine_distance_{key}"],
                                              lambda: float(_jax_suite(name, **kw)[key]), tol)


@pytest.mark.slow
@pytest.mark.parametrize("name", GOLDEN)
def test_release_reproduces_refined_record(name):
    _, net, cfg, _, style, record = _golden(name)
    assert record["refined_steps"] == REFINED_STEPS
    got = evaluate_golden_suite(net, load_golden_suite(), cfg, style_override=style, device="cpu",
                                refine_steps=REFINED_STEPS)
    keys = [k for k in ("mean_psnr", "heldout_mean_psnr") if f"refined_{k}" in record]
    assert "mean_psnr" in keys
    for key in keys:
        held_to_record_or_no_farther_than_jax(got[key], record[f"refined_{key}"],
                                              lambda: float(_jax_suite(name, refine_steps=REFINED_STEPS)[key]),
                                              RECORD_DB)
