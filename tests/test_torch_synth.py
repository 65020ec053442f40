"""Hologram synthesis of the port against the JAX package's ``data/synth.py``.

The port draws a batch on the host from a ``torch.Generator``; the JAX
package from ``jax.random``. The streams differ, so the tests repeat
``synth_batch``'s own ``jax.random`` calls (its keys, splits and fold-in)
and hand those draws to the port's ``render_batch``: the same batch must
come out, within 1e-5 of max, with the warp off and on (rotate 20 deg,
elastic 2.5 px). The pieces: the cubic weights against ``jax.image.resize``
(1e-6 of max) and the bilinear gather against
``jax.scipy.ndimage.map_coordinates`` (1e-6), the digit banks, and the
draws' determinism. Width of the synthesis: 64^2, B = 2, pad 16.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_cpu_threads import warm_torch_threads  # noqa: F401

from style_transfer_based_holographic_imaging_tpu.config import DataConfig as JData
from style_transfer_based_holographic_imaging_tpu.config import PhysicsConfig as JPhysics
from style_transfer_based_holographic_imaging_tpu.data import load_golden_suite as j_load_goldens
from style_transfer_based_holographic_imaging_tpu.data import synth as jsynth
from style_transfer_based_holographic_imaging_tpu_torch import DataConfig, PhysicsConfig
from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite
from style_transfer_based_holographic_imaging_tpu_torch.data import synth

SMALL = dict(batch_size=2, image_size=64, digit_pad=16)
WARPS = {"off": dict(rotate_deg=0.0, elastic_px=0.0), "on": dict(rotate_deg=20.0, elastic_px=2.5)}
SYNTH_TOL = 1e-5
RESIZE_TOL = 1e-6


def rel_max(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def goldens():
    return load_golden_suite()


@pytest.fixture(scope="module")
def golden_bank(goldens):
    """The train-split digits at 32^2: padded by 16, a 64^2 canvas."""
    return synth.golden_digit_bank(goldens, size=32, subset=synth.GOLDEN_TRAIN_DIGITS)


# --------------------------------------------------------------------------
# The pieces
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape,out", [
    ((3, 8, 8), (3, 64, 64)),         # sklearn digits to the bank
    ((2, 28, 28), (2, 64, 64)),       # an MNIST export to the bank
    ((2, 8, 8), (2, 80, 80)),         # one sample's flow cells to its warped tile
    ((2, 128, 96), (2, 64, 40)),      # shrinking: the antialiased kernel
    ((1, 16, 16), (1, 16, 48)),       # one axis kept
])
def test_resize_cubic_matches_jax_image_resize(shape, out):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), out, method="cubic"))
    got = synth.resize_cubic(torch.from_numpy(x), out[-2], out[-1]).numpy()
    assert got.shape == want.shape
    assert rel_max(got, want) < RESIZE_TOL


def test_bilinear_gather_matches_map_coordinates():
    rng = np.random.default_rng(1)
    img = rng.random((3, 20, 24)).astype(np.float32)
    # coordinates around and beyond the edges: zero fill outside
    ys = rng.uniform(-3, 23, size=(3, 20, 24)).astype(np.float32)
    xs = rng.uniform(-3, 27, size=(3, 20, 24)).astype(np.float32)
    want = np.stack([
        np.asarray(jax.scipy.ndimage.map_coordinates(img[i], [ys[i], xs[i]], order=1,
                                                     mode="constant", cval=0.0))
        for i in range(3)
    ])
    got = synth._map_coordinates_linear(torch.from_numpy(img), torch.from_numpy(ys),
                                        torch.from_numpy(xs)).numpy()
    assert rel_max(got, want) < RESIZE_TOL


# --------------------------------------------------------------------------
# Synthesis given the JAX package's draws
# --------------------------------------------------------------------------


def jax_draws(key, n_bank: int, data: JData):
    """``synth_batch``'s jax.random calls (synth.py:318-331, 352-358), as the
    port's draws."""
    b = data.batch_size
    max_shift = int(round(data.translate_frac * data.image_size))
    ks = jax.random.split(key, 8)
    idx_s = jax.random.randint(ks[0], (b,), 0, n_bank)
    idx_c = jax.random.randint(ks[1], (b,), 0, n_bank)
    flips = jax.random.bernoulli(ks[2], 0.5, (2, b, 2))
    shifts = jax.random.randint(ks[3], (2, b, 2), -max_shift, max_shift + 1)
    pscale = jax.random.uniform(ks[6], (2, b, 1, 1), minval=data.phase_scale_range[0],
                                maxval=data.phase_scale_range[1])
    pgamma = jax.random.uniform(ks[7], (2, b, 1, 1), minval=data.gamma_range[0],
                                maxval=data.gamma_range[1])
    ds = jax.random.randint(ks[4], (b,), 0, len(data.style_distances))
    dc = jax.random.randint(ks[5], (b,), 0, len(data.content_distances))
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    draws = {
        "idx": t(jnp.stack([idx_s, idx_c])).long(),
        "flips": t(flips),
        "shifts": t(shifts).long(),
        "pscale": t(pscale.reshape(2, b)),
        "pgamma": t(pgamma.reshape(2, b)),
        "d_idx": t(jnp.stack([ds, dc])).long(),
    }
    if data.rotate_deg or data.elastic_px:
        kw_s, kw_c = jax.random.split(jax.random.fold_in(key, 0x5A17))
        angles, flows = [], []
        for kw in (kw_s, kw_c):
            a, f = [], []
            for k in jax.random.split(kw, b):
                k_rot, k_flow = jax.random.split(k)
                a.append(jax.random.uniform(k_rot, (), minval=-data.rotate_deg, maxval=data.rotate_deg))
                f.append(jax.random.normal(k_flow, (2, data.elastic_cells, data.elastic_cells)))
            angles.append(jnp.stack(a))
            flows.append(jnp.stack(f))
        draws["angle"] = t(jnp.stack(angles))
        if data.elastic_px:
            draws["flow"] = t(jnp.stack(flows))
    return draws


@pytest.mark.parametrize("warp", sorted(WARPS))
def test_render_of_the_jax_draws_matches_synth_batch(warp, golden_bank):
    jdata = JData(**SMALL, **WARPS[warp], seed=3)
    data = DataConfig(**SMALL, **WARPS[warp], seed=3)
    key = jax.random.fold_in(jax.random.key(3), 5)
    want = jsynth.synth_batch(key, jnp.asarray(golden_bank), data=jdata, physics=JPhysics(),
                              return_gt=True)
    got = synth.render_batch(torch.from_numpy(golden_bank), jax_draws(key, len(golden_bank), jdata),
                             data, PhysicsConfig(), return_gt=True)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert rel_max(got[k].numpy(), want[k]) < SYNTH_TOL, k


def test_the_warp_moves_the_object(golden_bank):
    """The warp's draws reach the render: the same draws with their angles
    and flows zeroed give another phase object."""
    data = DataConfig(**SMALL, **WARPS["on"])
    draws = synth.draw_batch(synth.stream_generator(0, 0), len(golden_bank), data)
    bank = torch.from_numpy(golden_bank)
    warped = synth.render_batch(bank, draws, data, PhysicsConfig(), return_gt=True)
    still = synth.render_batch(bank, {**draws, "angle": draws["angle"] * 0, "flow": draws["flow"] * 0},
                               data, PhysicsConfig(), return_gt=True)
    assert float((warped["phase_content"] - still["phase_content"]).abs().max()) > 0.1


# --------------------------------------------------------------------------
# The port's own draws
# --------------------------------------------------------------------------


def test_draws_are_reproducible_and_follow_the_iteration(golden_bank):
    data = DataConfig(**SMALL, **WARPS["on"], seed=4)
    bank = torch.from_numpy(golden_bank)
    a = synth.synth_batch(7, bank, data, PhysicsConfig(), return_gt=True)
    b = synth.synth_batch(7, bank, data, PhysicsConfig(), return_gt=True)
    c = synth.synth_batch(8, bank, data, PhysicsConfig(), return_gt=True)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["content_holo"], c["content_holo"])
    sampler = synth.InfiniteHologramSampler(golden_bank, data, PhysicsConfig(), return_gt=True,
                                            start_iteration=7, device="cpu")
    first, second = next(sampler), next(sampler)
    assert torch.equal(first["phase_content"], a["phase_content"])
    assert torch.equal(second["content_holo"], c["content_holo"])
    assert sampler.iteration == 9


def test_draws_lie_in_their_ranges(golden_bank):
    data = DataConfig(**SMALL, **WARPS["on"])
    d = synth.draw_batch(synth.stream_generator(0, 1), len(golden_bank), data)
    assert d["idx"].shape == (2, 2) and int(d["idx"].max()) < len(golden_bank)
    assert int(d["shifts"].abs().max()) <= round(0.1 * 64)
    assert float(d["pscale"].min()) >= 0.7 and float(d["pscale"].max()) <= 1.0
    assert float(d["pgamma"].min()) >= 0.6 and float(d["pgamma"].max()) <= 1.6
    assert float(d["angle"].abs().max()) <= 20.0
    assert d["flow"].shape == (2, 2, 2, 8, 8)
    batch = synth.render_batch(torch.from_numpy(golden_bank), d, data, PhysicsConfig())
    dc = batch["distance_content"].reshape(-1).numpy()
    assert all(np.isclose(d, (0.4, 0.5, 0.6, 0.7, 0.8), rtol=0, atol=1e-6).any() for d in dc)
    assert np.allclose(batch["distance_style"].numpy(), 0.2)


# --------------------------------------------------------------------------
# Digit banks
# --------------------------------------------------------------------------


def test_golden_and_mixed_banks_match_jax(goldens):
    jg = j_load_goldens()
    want = jsynth.golden_digit_bank(jg, subset=jsynth.GOLDEN_TRAIN_DIGITS)
    got = synth.golden_digit_bank(goldens, subset=synth.GOLDEN_TRAIN_DIGITS)
    np.testing.assert_array_equal(got, want)
    assert rel_max(synth.golden_digit_bank(goldens, size=32), jsynth.golden_digit_bank(jg, size=32)) < RESIZE_TOL
    mixed, jmixed = synth.mixed_digit_bank(goldens, oversample=2), jsynth.mixed_digit_bank(jg, oversample=2)
    assert mixed.shape == jmixed.shape == (1797 + 100, 64, 64)
    assert rel_max(mixed, jmixed) < RESIZE_TOL


@pytest.mark.parametrize("key,dtype", [("x_train", np.uint8), ("bank", np.float32)])
def test_load_digit_bank_matches_jax(tmp_path, key, dtype):
    rng = np.random.default_rng(2)
    arr = (rng.integers(0, 256, size=(4, 28, 28)).astype(dtype) if dtype == np.uint8
           else rng.random((4, 64, 64)).astype(dtype))
    path = str(tmp_path / "bank.npz")
    np.savez(path, **{key: arr})
    got, want = synth.load_digit_bank(path), jsynth.load_digit_bank(path)
    assert got.shape == want.shape == (4, 64, 64)
    assert rel_max(got, want) < RESIZE_TOL


def test_sklearn_banks_raise_without_sklearn(monkeypatch, goldens):
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.datasets", None)
    with pytest.raises(ImportError, match="scikit-learn"):
        synth.sklearn_digit_bank()
    with pytest.raises(ImportError, match="scikit-learn"):
        synth.mixed_digit_bank(goldens)


def test_config_carries_the_synthesis_fields():
    j = dataclasses.asdict(JData())
    p = dataclasses.asdict(DataConfig())
    assert p == j
