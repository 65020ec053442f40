"""The port's numpy reproduction of ``jax.random`` (``utils/jax_random.py``)
against ``jax.random`` itself, and the JAX-keyed synthesis built on it.

* ``key``, ``fold_in``, ``split``, 32-bit ``bits``, ``randint`` (negative
  minimum, spans of one, empty and the whole int32 range), ``uniform``
  (several ranges) and ``bernoulli``: equal bit for bit, over seeds and
  shapes (the installed JAX, partitionable threefry counters).
* ``fma32`` against XLA's fused multiply-add on the CPU: bit for bit.
* ``synth.jax_key_draws`` equal bit for bit to ``synth_batch``'s own
  ``jax.random`` calls (``tests/test_torch_synth.py``'s ``jax_draws``), and
  ``synth_batch_from_key`` against the JAX package's ``synth_batch`` for the
  MNIST, rbc and bead presets: every output within 1e-5 of its max (the
  synthesis's rule, ``tests/test_torch_synth.py``). A warp config's draws
  are ``synth_batch``'s too: its keys and angles bit for bit, its flows
  (``normal``) within ``tests/test_torch_warp.py``'s 4 ulp.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_synth import jax_draws
from test_torch_warp import NORMAL_ULPS, ulps
from torch_cpu_threads import warm_few_torch_threads  # noqa: F401

from style_transfer_based_holographic_imaging_tpu.config import DOMAIN_PRESETS as J_PRESETS
from style_transfer_based_holographic_imaging_tpu.data import synth as jsynth
from style_transfer_based_holographic_imaging_tpu_torch.config import DOMAIN_PRESETS
from style_transfer_based_holographic_imaging_tpu_torch.data import synth
from style_transfer_based_holographic_imaging_tpu_torch.utils import jax_random as jr

SEEDS = (0, 1, 42, 1234, 7777, 2**31 - 1)
SHAPES = ((1,), (7,), (2, 3, 2), (2, 32), (4096,))
INT_RANGES = ((0, 10), (0, 512), (-13, 14), (0, 1), (5, 5), (7, 3), (3, 100_000),
              (0, 2**31 - 1), (-(2**31), 2**31 - 1))
FLOAT_RANGES = ((0.0, 1.0), (0.7, 1.0), (0.6, 1.6), (-25.0, 25.0), (3.0, 3.0), (-1e-3, 7.5))
SMALL = dict(batch_size=4, image_size=64, digit_pad=16)
SYNTH_TOL = 1e-5


def _data(k):
    return np.asarray(jax.random.key_data(k))


def bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_and_split(seed):
    k = jax.random.key(seed)
    assert bits_equal(jr.key(seed), _data(k))
    for data in (0, 3, 0x5A17, 2**32 - 1):
        assert bits_equal(jr.fold_in(jr.key(seed), data), _data(jax.random.fold_in(k, data)))
    for num in (2, 8, 33):
        assert bits_equal(jr.split(jr.key(seed), num), _data(jax.random.split(k, num)))
    # a key deep in the stream: split of a fold-in of a split
    deep = jax.random.split(jax.random.fold_in(jax.random.split(k, 3)[2], 9), 4)[1]
    mine = jr.split(jr.fold_in(jr.split(jr.key(seed), 3)[2], 9), 4)[1]
    assert bits_equal(mine, _data(deep))


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_randint_uniform_bernoulli(seed):
    k, nk = jax.random.key(seed), jr.key(seed)
    for shape in SHAPES:
        assert bits_equal(jr.random_bits(nk, shape), np.asarray(jax.random.bits(k, shape)))
        for lo, hi in INT_RANGES:
            assert bits_equal(jr.randint(nk, shape, lo, hi),
                              np.asarray(jax.random.randint(k, shape, lo, hi))), (shape, lo, hi)
        for lo, hi in FLOAT_RANGES:
            want = np.asarray(jax.random.uniform(k, shape, minval=lo, maxval=hi))
            assert bits_equal(jr.uniform(nk, shape, lo, hi), want), (shape, lo, hi)
        for p in (0.5, 0.1):
            assert bits_equal(jr.bernoulli(nk, p, shape), np.asarray(jax.random.bernoulli(k, p, shape)))


@pytest.mark.parametrize("b,c", [(0.3, 0.7), (1.0, 0.6), (50.0, -25.0), (2.0**-20, 1.0)])
def test_fma32_is_xlas_fused_multiply_add(b, c):
    a = np.random.default_rng(0).random(1 << 18).astype(np.float32)
    b, c = np.float32(b), np.float32(c)
    want = np.asarray(jax.jit(lambda x: x * b + c)(a))
    assert bits_equal(jr.fma32(a, b, c), want)


def _configs(name):
    jcfg, cfg = J_PRESETS[name](), DOMAIN_PRESETS[name]()
    return (dataclasses.replace(jcfg, data=dataclasses.replace(jcfg.data, **SMALL)),
            dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, **SMALL)))


@pytest.mark.parametrize("seed,i", [(7777, 0), (7777, 9), (1234, 3)])
def test_jax_key_draws_are_synth_batchs_draws(seed, i):
    for name in ("mnist", "red_blood_cell", "polystyrene"):
        jcfg, cfg = _configs(name)
        got = synth.jax_key_draws(jr.fold_in(jr.key(seed), i), 300, cfg.data)
        want = jax_draws(jax.random.fold_in(jax.random.key(seed), i), 300, jcfg.data)
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), (name, key)


@pytest.mark.parametrize("name,bank", [("mnist", "golden"), ("red_blood_cell", "rbc"),
                                       ("polystyrene", "bead")])
def test_synth_batch_from_key_matches_jax_synth_batch(name, bank):
    jcfg, cfg = _configs(name)
    if bank == "golden":
        from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite

        objects = synth.golden_digit_bank(load_golden_suite(), size=32, subset=synth.GOLDEN_TRAIN_DIGITS)
    else:
        objects = getattr(synth, f"{bank}_bank")(n=64, size=32, seed=7919)
    want = jsynth.synth_batch(jax.random.fold_in(jax.random.key(7777), 2), jnp.asarray(objects),
                              data=jcfg.data, physics=jcfg.physics, return_gt=True)
    got = synth.synth_batch_from_key(jr.fold_in(jr.key(7777), 2), torch.from_numpy(objects),
                                     cfg.data, cfg.physics, return_gt=True)
    assert set(got) == set(want)
    for key in want:
        w = np.asarray(want[key], np.float64)
        g = got[key].numpy().astype(np.float64)
        assert g.shape == w.shape, key
        assert np.abs(g - w).max() <= SYNTH_TOL * max(np.abs(w).max(), 1e-30), key


def test_a_warp_config_is_refused():
    """No longer refused: a warp config's draws are ``synth_batch``'s, the
    rotation angles bit for bit and the elastic flows within 4 ulp (the
    bound of ``jax_random.normal``)."""
    for warp in (dict(rotate_deg=10.0), dict(rotate_deg=20.0, elastic_px=2.5)):
        data = dataclasses.replace(DOMAIN_PRESETS["mnist"]().data, **SMALL, **warp)
        jdata = dataclasses.replace(J_PRESETS["mnist"]().data, **SMALL, **warp)
        got = synth.jax_key_draws(jr.key(0), 10, data)
        want = jax_draws(jax.random.key(0), 10, jdata)
        assert set(got) == set(want)
        for key in want:
            if key == "flow":
                assert got[key].shape == want[key].shape
                assert ulps(got[key].numpy(), want[key].numpy()).max() <= NORMAL_ULPS
            else:
                assert got[key].dtype == want[key].dtype and torch.equal(got[key], want[key]), key
