"""The port's physics and statistics ops against the JAX package's.

Relative tolerance 1e-5 of max|ref| (fp32 sums taken in another order),
except where stated: the static and per-sample refocus distances must agree
bit for bit, and the congruent unwrap must match exactly in whole multiples
of 2 pi away from ties of its rounding. The propagator's grids, made once
a device and shape, give what fresh ones give, bit for bit, and keep their
gradient after a first call under ``torch.inference_mode``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_based_holographic_imaging_tpu import ops as jops
from style_transfer_based_holographic_imaging_tpu.config import PhysicsConfig as JPhysics
from style_transfer_based_holographic_imaging_tpu.eval import metrics as jmetrics
from style_transfer_based_holographic_imaging_tpu.ops.holo import (
    _to_metres_maybe_static as j_to_metres,
)
from style_transfer_based_holographic_imaging_tpu.ops import unwrap as junwrap
from style_transfer_based_holographic_imaging_tpu_torch import ExperimentConfig, PhysicsConfig
from style_transfer_based_holographic_imaging_tpu_torch import ops as tops
from style_transfer_based_holographic_imaging_tpu_torch.eval import metrics as tmetrics
from style_transfer_based_holographic_imaging_tpu_torch.ops.holo import (
    _to_metres_maybe_static as t_to_metres,
)
from style_transfer_based_holographic_imaging_tpu_torch.utils.misc import static_scalar

TOL = 1e-5
PHYSICS = [
    dict(),
    dict(distance_normalize=25.0, distance_normalize_constant=0.3),
    dict(distance_normalize=10.0, phase_normalize=0.5),
]


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _amp_phase(b=3, n=32, seed=0):
    rng = np.random.default_rng(seed)
    amp = (0.5 + 0.5 * rng.random((b, 1, n, n))).astype(np.float32)
    ph = rng.random((b, 1, n, n)).astype(np.float32)
    return amp, ph


@pytest.mark.parametrize("phys", PHYSICS)
@pytest.mark.parametrize("d", [0.417, -0.2, 0.8])
def test_static_distance_matches_tensor_path_bitwise(phys, d):
    p = PhysicsConfig(**phys)
    static = t_to_metres(d, p)
    tensor = float(t_to_metres(torch.tensor(d, dtype=torch.float32), p))
    assert isinstance(static, float)
    assert static == tensor
    assert static == j_to_metres(d, JPhysics(**phys))


@pytest.mark.parametrize("phys", PHYSICS)
def test_holo_forward_static_and_per_sample_bitwise(phys):
    p = PhysicsConfig(**phys)
    amp, ph = _amp_phase()
    a, q = torch.from_numpy(amp), torch.from_numpy(ph)
    static = tops.holo_forward(a, q, 0.3, p)
    per_sample = tops.holo_forward(a, q, torch.full((3, 1, 1, 1), 0.3), p)
    assert torch.equal(static, per_sample)


@pytest.mark.parametrize("phys", PHYSICS)
@pytest.mark.parametrize("mode", ["intensity", "field", "field_unwrap", "complex"])
def test_holo_forward_matches_jax(phys, mode):
    amp, ph = _amp_phase(seed=1)
    d = np.asarray([0.4, 0.6, 0.8], np.float32).reshape(3, 1, 1, 1)
    kw = {
        "intensity": {},
        "field": {"return_field": True},
        "field_unwrap": {"return_field": True, "unwrap": True},
        "complex": {"complex_number": True},
    }[mode]
    ref = jops.holo_forward(jnp.asarray(amp), jnp.asarray(ph), jnp.asarray(d), JPhysics(**phys), **kw)
    got = tops.holo_forward(torch.from_numpy(amp), torch.from_numpy(ph), torch.from_numpy(d),
                            PhysicsConfig(**phys), **kw)
    if mode in ("field", "field_unwrap"):
        # amplitude to 1e-5 of its max; phase to 1e-5 of pi, modulo whole
        # cycles (the unwrapped phase is congruent; a tie may move a cycle)
        assert _rel(got[0].numpy(), ref[0]) < TOL
        dph = got[1].numpy() - np.asarray(ref[1])
        wrapped = np.mod(dph + math.pi, 2 * math.pi) - math.pi
        assert np.abs(wrapped).max() < TOL * math.pi
    else:
        assert _rel(got.numpy(), ref) < TOL


def test_back_prop_matches_jax():
    rng = np.random.default_rng(2)
    holo = (0.2 + rng.random((2, 1, 32, 32))).astype(np.float32)
    d = np.asarray([0.3, 0.5], np.float32).reshape(2, 1, 1, 1)
    p = PhysicsConfig()
    for output in ("amp_pha", "real_imag"):
        ref = jops.back_prop(jnp.asarray(holo), jnp.asarray(d), JPhysics(), output=output)
        got = tops.back_prop(torch.from_numpy(holo), torch.from_numpy(d), p, output=output)
        assert got.shape == ref.shape
        if output == "amp_pha":
            assert _rel(got[:, 0].numpy(), ref[:, 0]) < TOL
        else:
            assert _rel(got.numpy(), ref) < TOL


def test_wrap_phase_matches_jax():
    x = np.linspace(-20.0, 20.0, 4001, dtype=np.float32)
    got = tops.wrap_phase(torch.from_numpy(x)).numpy()
    ref = np.asarray(jops.wrap_phase(jnp.asarray(x)))
    assert np.abs(got - ref).max() < 1e-5


def _wrapped_surface(b=3, n=48, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(-1, 1, n), np.linspace(-1, 1, n), indexing="ij")
    surf = np.stack([
        (6.0 + 4.0 * rng.random()) * np.exp(-((xx - rng.uniform(-0.3, 0.3)) ** 2 + yy**2) / 0.3)
        + rng.uniform(-3, 3) * xx
        for _ in range(b)
    ])[:, None]
    return np.mod(surf + math.pi, 2 * math.pi).astype(np.float32) - np.float32(math.pi)


def test_dct_matrix_matches_jax():
    for n in (16, 48, 128):
        assert np.array_equal(tops.unwrap._dct_mat(n), junwrap._dct_mat(n))


def test_unwrap_least_squares_matches_jax():
    w = _wrapped_surface()
    got = tops.unwrap_phase(torch.from_numpy(w), congruent=False).numpy()
    ref = np.asarray(jops.unwrap_phase(jnp.asarray(w), congruent=False))
    assert _rel(got, ref) < TOL


def test_unwrap_congruent_matches_jax_in_whole_cycles():
    w = _wrapped_surface(seed=1)
    got = tops.unwrap_phase(torch.from_numpy(w)).numpy()
    ref = np.asarray(jops.unwrap_phase(jnp.asarray(w)))
    psi = np.asarray(jops.unwrap_phase(jnp.asarray(w), congruent=False))
    k_got = np.round((got - w) / (2 * math.pi))
    k_ref = np.round((ref - w) / (2 * math.pi))
    frac = (psi - w) / (2 * math.pi)
    away_from_ties = np.abs(np.abs(frac - np.floor(frac)) - 0.5) > 1e-3
    assert away_from_ties.mean() > 0.99
    assert np.array_equal(k_got[away_from_ties], k_ref[away_from_ties])
    # both outputs stay congruent to the input
    assert np.abs((got - w) / (2 * math.pi) - k_got).max() < 1e-4


def test_calc_mean_std_and_adain_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 16, 8, 12)).astype(np.float32)      # NCHW
    s = rng.normal(size=(2, 16, 5, 7)).astype(np.float32)
    x_nhwc, s_nhwc = x.transpose(0, 2, 3, 1), s.transpose(0, 2, 3, 1)
    m, sd = tops.calc_mean_std(torch.from_numpy(x))
    jm, jsd = jops.calc_mean_std(jnp.asarray(x_nhwc))
    assert m.shape == (2, 16, 1, 1)
    assert _rel(m.numpy()[:, :, 0, 0], np.asarray(jm)[:, 0, 0]) < TOL
    assert _rel(sd.numpy()[:, :, 0, 0], np.asarray(jsd)[:, 0, 0]) < TOL

    got = tops.adain(torch.from_numpy(x), torch.from_numpy(s)).numpy()
    ref = np.asarray(jops.adain(jnp.asarray(x_nhwc), jnp.asarray(s_nhwc))).transpose(0, 3, 1, 2)
    assert _rel(got, ref) < TOL

    sm = rng.normal(size=(1, 1, 1, 16)).astype(np.float32)
    ss = (1.0 + rng.random((1, 1, 1, 16))).astype(np.float32)
    got = tops.adain_with_stats(
        torch.from_numpy(x), torch.from_numpy(sm.transpose(0, 3, 1, 2)),
        torch.from_numpy(ss.transpose(0, 3, 1, 2)),
    ).numpy()
    ref = np.asarray(jops.adain_with_stats(jnp.asarray(x_nhwc), jnp.asarray(sm), jnp.asarray(ss)))
    assert _rel(got, ref.transpose(0, 3, 1, 2)) < TOL


def test_calc_mean_std_rejects_unbatched():
    with pytest.raises(ValueError):
        tops.calc_mean_std(torch.zeros(4, 8, 8))


def test_metrics_match_jax():
    rng = np.random.default_rng(4)
    pred = rng.random((5, 1, 16, 16)).astype(np.float32)
    target = rng.random((5, 1, 16, 16)).astype(np.float32)
    tp, tt = torch.from_numpy(pred), torch.from_numpy(target)
    for rng_arg in (None, 1.0):
        assert abs(float(tmetrics.psnr(tp, tt, rng_arg)) - float(jmetrics.psnr(pred, target, rng_arg))) < 1e-4
    want = float(jmetrics.mae(pred, target))
    assert abs(float(tmetrics.mae(tp, tt)) - want) < TOL * want
    assert _rel(tmetrics.zero_mean(tp).numpy(), jmetrics.zero_mean(jnp.asarray(pred))) < TOL
    y = rng.random(20) * 400 + 400
    yp = y + rng.normal(size=20)
    assert abs(float(tmetrics.r2_score(y, yp)) - float(jmetrics.r2_score(y, yp))) < 1e-6
    p = PhysicsConfig(distance_normalize=25.0, distance_normalize_constant=0.3)
    assert np.allclose(tmetrics.distances_to_um(y, p), jmetrics.distances_to_um(y, p))


@pytest.mark.parametrize("pred,want", [([2.0, 2.0, 2.0], 1.0), ([2.0, 2.5, 2.0], 0.0)])
def test_r2_constant_target(pred, want):
    y = np.full(3, 2.0)
    assert float(tmetrics.r2_score(y, np.asarray(pred))) == want
    assert float(jmetrics.r2_score(y, np.asarray(pred))) == want


def test_static_scalar():
    assert static_scalar(3) == 3.0
    assert static_scalar(np.float32(0.5)) == 0.5
    assert static_scalar(np.full((1, 1, 1, 1), 0.2, np.float32)) == float(np.float32(0.2))
    assert static_scalar(True) is None
    assert static_scalar(np.zeros(2)) is None
    assert static_scalar(torch.tensor(0.2)) is None


def test_config_parses_release_config():
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "checkpoints", "config.json")) as f:
        cfg = ExperimentConfig.from_json(f.read())
    assert cfg.model.width == 1.0 and not cfg.model.with_phase_decoder
    assert cfg.physics == PhysicsConfig(wavelength=5.32e-07, pixel_size=1.5e-06)
    assert cfg.physics.to_network_units(cfg.physics.to_metres(0.4) * 1e3) == pytest.approx(0.4)
    assert cfg.eval.alpha == 1.0


@pytest.mark.parametrize("band_limit", [False, True])
def test_propagate_grids_made_once_keep_results_and_gradients(band_limit):
    from style_transfer_based_holographic_imaging_tpu_torch.ops import asm

    kw = dict(wavelength=5.32e-7, pixel_size=1.5e-6, band_limit=band_limit)
    rng = np.random.default_rng(3)
    x = torch.complex(*(torch.from_numpy(rng.standard_normal((2, 1, 24, 24)).astype(np.float32)) for _ in "ri"))
    d = torch.tensor([4e-3, 7e-3]).reshape(2, 1, 1, 1)
    asm._cached_grids.cache_clear()
    with torch.inference_mode():  # the first call makes the grids
        first = asm.propagate_torch(x, d, **kw)
    d_grad = d.clone().requires_grad_(True)
    again = asm.propagate_torch(x, d_grad, **kw)
    assert torch.equal(first, again.detach())
    (grad,) = torch.autograd.grad(again.abs().square().sum() + again.real.sum(), d_grad)
    assert torch.isfinite(grad).all() and grad.abs().max() > 0
    fresh = asm._make_grids(48, 48, kw["pixel_size"], kw["wavelength"], torch.device("cpu"))
    assert all(torch.equal(a, b) for a, b in zip(asm._cached_grids(48, 48, kw["pixel_size"], kw["wavelength"],
                                                                   torch.device("cpu")), fresh))
