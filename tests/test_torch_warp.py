"""The synthesis's warp and the morphed digit bank on the port against the
JAX package on the CPU: ``jax.random.normal``, the warp's draws and batches,
``morphed_digit_bank`` and ``scripts/port_make_big_bank.py``.

* ``jax_random.normal`` against ``jax.random.normal`` (float32): every
  element within 4 ulp over three keys and the shapes the warp and a larger
  draw take; the share of elements equal bit for bit is reported (XLA's
  ``ErfInv``, ``log1p`` and ``log`` reproduced, 99.996 % over 600,000
  draws; scipy's ``erfinv`` reads up to 91 ulp off).
* ``synth_batch_from_key`` with the flagship's warp (rotate 20 deg, elastic
  2.5 px on 8 x 8 cells) against the JAX package's ``synth_batch`` on the
  same key: holograms and ground truth within 1e-5 of max (the synthesis's
  rule, ``tests/test_torch_synth.py``; read 4e-6 on the phase objects: fp32
  cos/sin and gather weights on each side).
* ``morphed_digit_bank(base, 24, seed=7, batch=8)`` (one full and one
  partial chunk) against the JAX package's: within 1e-5 of max (the affine
  map's 2x2 inverse and fp32 trig, read 1.6e-6); the originals come back
  verbatim; the bank is deterministic in ``seed``.
* ``scripts/port_make_big_bank.py`` against ``scripts/make_big_bank.py`` at
  a small ``--n``: the same uint8 bank but for a rounding boundary, one grey
  level, on at most 1e-4 of the values.
"""

import dataclasses
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import CONFIG_TEXT, SMALL_DATA
from torch_cpu_threads import warm_few_torch_threads  # noqa: F401

from style_transfer_based_holographic_imaging_tpu.config import ExperimentConfig as JConfig
from style_transfer_based_holographic_imaging_tpu.data import synth as jsynth
from style_transfer_based_holographic_imaging_tpu_torch import ExperimentConfig
from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite, synth
from style_transfer_based_holographic_imaging_tpu_torch.utils import jax_random as jr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NORMAL_ULPS = 4
SYNTH_TOL = 1e-5
BANK_TOL = 1e-5
BANK_GREY_SHARE = 1e-4


def ulps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Elementwise distance in float32 ulps (through the ordered integers)."""
    def ordered(a):
        i = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(got) - ordered(want))


def rel_max(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def bank():
    return synth.golden_digit_bank(load_golden_suite(), size=32, subset=synth.GOLDEN_TRAIN_DIGITS)


@pytest.mark.parametrize("shape", [(2, 8, 8), (4096,)])
@pytest.mark.parametrize("seed", [0, 3, 7777])
def test_normal_is_jax_random_normal(seed, shape, record_property):
    want = np.asarray(jax.random.normal(jax.random.key(seed), shape, jnp.float32))
    got = jr.normal(jr.key(seed), shape)
    assert got.shape == want.shape and got.dtype == np.float32
    d = ulps(got, want)
    exact = float((d == 0).mean())
    record_property("exact_share", exact)
    print(f"normal key {seed} {shape}: {exact:.6f} of the elements bit for bit, max {d.max()} ulp")
    assert d.max() <= NORMAL_ULPS, (d.max(), exact)


def test_normal_of_keys_is_normal_of_each_key():
    """A stack of keys draws what each key draws (``jax.vmap``)."""
    keys = jr.split(jr.key(11), 5)
    stacked = jr.normal(keys, (2, 4, 4))
    for k, row in zip(keys, stacked):
        assert np.array_equal(row, jr.normal(k, (2, 4, 4)))


def _flagship_configs():
    out = []
    for cls in (JConfig, ExperimentConfig):
        c = cls.from_json(CONFIG_TEXT)
        out.append(dataclasses.replace(c, data=dataclasses.replace(c.data, **SMALL_DATA)))
    return out


@pytest.mark.parametrize("seed,i", [(0, 0), (7777, 3)])
def test_synth_batch_from_key_with_the_flagships_warp_matches_jax(seed, i, bank):
    jcfg, cfg = _flagship_configs()
    assert cfg.data.rotate_deg == 20.0 and cfg.data.elastic_px == 2.5
    want = jax.device_get(jsynth.synth_batch(jax.random.fold_in(jax.random.key(seed), i), jnp.asarray(bank),
                                             data=jcfg.data, physics=jcfg.physics, return_gt=True))
    got = synth.synth_batch_from_key(jr.fold_in(jr.key(seed), i), torch.from_numpy(bank), cfg.data,
                                     cfg.physics, return_gt=True)
    assert set(got) == set(want)
    for key in want:
        assert tuple(got[key].shape) == np.shape(want[key]), key
        assert rel_max(got[key].numpy(), want[key]) < SYNTH_TOL, key
    still = synth.synth_batch_from_key(
        jr.fold_in(jr.key(seed), i), torch.from_numpy(bank),
        dataclasses.replace(cfg.data, rotate_deg=0.0, elastic_px=0.0), cfg.physics, return_gt=True)
    assert float((got["phase_content"] - still["phase_content"]).abs().max()) > 0.1


def test_morphed_digit_bank_matches_jax(bank):
    base = bank[:10]
    want = jsynth.morphed_digit_bank(base, 24, seed=7, batch=8)
    got = synth.morphed_digit_bank(base, 24, seed=7, batch=8, device="cpu")
    assert got.shape == want.shape == (24, 32, 32) and got.dtype == np.float32
    assert np.array_equal(got[:10], base)
    assert rel_max(got, want) < BANK_TOL
    again = synth.morphed_digit_bank(base, 24, seed=7, batch=8, device="cpu")
    assert np.array_equal(again, got)
    other = synth.morphed_digit_bank(base, 24, seed=8, batch=8, device="cpu")
    assert np.array_equal(other[:10], base) and not np.allclose(other[10:], got[10:])
    assert np.array_equal(synth.morphed_digit_bank(base, 6, seed=7, device="cpu"), base[:6])


def test_port_make_big_bank_writes_the_jax_scripts_bank(tmp_path, monkeypatch):
    pytest.importorskip("sklearn")
    paths = {}
    for name in ("make_big_bank", "port_make_big_bank"):
        paths[name] = str(tmp_path / f"{name}.npz")
        argv = [name, "--n", "120", "--seed", "3", "--out", paths[name]]
        if name.startswith("port"):
            argv.append("--cpu")
        monkeypatch.setattr(sys, "argv", argv)
        runpy.run_path(os.path.join(REPO, "scripts", f"{name}.py"), run_name="__main__")
    with np.load(paths["make_big_bank"]) as z:
        want = z["bank"]
    with np.load(paths["port_make_big_bank"]) as z:
        got = z["bank"]
    assert got.shape == want.shape == (120, 64, 64) and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() <= BANK_GREY_SHARE
