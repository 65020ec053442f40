"""The port's FOV-sharded refocus (``parallel/fft_sharding.py``) in spawned
``gloo`` worlds on the CPU (``tests/torch_pp_world.py``: one 2-rank world
and one 4-rank world, shared with ``tests/test_torch_pp.py``), against the
JAX package's ``sharded_propagate`` on its 2-device mesh and its one-device
``ops.asm.propagate``.

A (2, 1, 64, 64) complex64 field, each rank holding its rows. Tolerances
are ``tests/test_fft_sharding.py``'s: the field within 1e-5 of the
reference's max, with and without the pad, and with the band limit at mm
distances. The two packages take the 2D FFT differently (two 1D passes and
an ``all_to_all`` here, ``jnp.fft`` inside ``shard_map`` or one 2D FFT
there), so they agree to rounding, not bit for bit (measured on this CPU:
about 3e-7 of the max). The JAX test holds the gradient of ``sum
|out|^2`` only finite; here it is held to ``jax.grad`` of the one-device
propagation (JAX's gradient of a real function of a complex input is the
conjugate of torch's) and to torch's gradient of the port's one-device
``propagate_torch``, within 3e-5 of the max: the pad's adjoint sums up to
half a side of rows into each edge row, and the two one-device
compositions already part by 1.07e-5 (measured on this CPU; the sharded
gradient 1.13e-5 from JAX's, 8.6e-6 from the port's; a gradient off by a
factor 2 reads 0.5). The ASM ops on each rank's share of a batch (the counterpart of
``TestMeshShardedPallas``) gather to the one-process call bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_pp_world import FFT_D, FFT_D_MM, KW, inputs, world

from style_transfer_based_holographic_imaging_tpu.ops import asm as jasm
from style_transfer_based_holographic_imaging_tpu.parallel import make_mesh as j_make_mesh
from style_transfer_based_holographic_imaging_tpu.parallel.fft_sharding import (
    fov_sharding as j_fov_sharding,
)
from style_transfer_based_holographic_imaging_tpu.parallel.fft_sharding import (
    sharded_propagate as j_sharded_propagate,
)
from style_transfer_based_holographic_imaging_tpu_torch.ops.asm import propagate, propagate_torch
from style_transfer_based_holographic_imaging_tpu_torch.parallel import fov_sharding, make_mesh

REL_TOL = 1e-5
GRAD_TOL = 3e-5

# case: (the rows of the field, the distance, propagate's keywords)
CASES = {
    "pad": (slice(None), np.asarray(FFT_D, np.float32).reshape(2, 1, 1, 1), {}),
    "no_pad": (slice(0, 1), 5e-4, {"pad": False}),
    "band_limit": (slice(None), np.asarray(FFT_D_MM, np.float32).reshape(2, 1, 1, 1), {"band_limit": True}),
}


def gathered(results, case):
    return np.concatenate([r["fft"][case].numpy() for r in results], axis=-2)


@pytest.fixture(scope="module")
def field():
    return inputs()["field"]


@pytest.fixture(scope="module")
def jax_refs(field):
    """Each case through JAX's ``sharded_propagate`` on a 2-device mesh and
    through its one-device ``propagate``, jitted (one compile a call)."""
    mesh = j_make_mesh(2)
    out = {}
    for case, (rows, d, kw) in CASES.items():
        f = jnp.asarray(field[rows])
        dd = jnp.asarray(d)
        sharded = jax.jit(functools.partial(j_sharded_propagate, mesh=mesh, **KW, **kw))
        out[case, "jax_sharded"] = np.asarray(sharded(jax.device_put(f, j_fov_sharding(mesh)), dd))
        out[case, "jax_propagate"] = np.asarray(jax.jit(functools.partial(jasm._propagate_xla, **KW, **kw))(f, dd))
    return out


@pytest.mark.parametrize("ref", ["jax_sharded", "jax_propagate"])
@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_match_jax(case, ref, jax_refs):
    want = jax_refs[case, ref]
    got = gathered(world(2), case)
    assert np.abs(got - want).max() / np.abs(want).max() < REL_TOL


@pytest.mark.parametrize("case", list(CASES))
def test_four_ranks_match_jax(case, jax_refs):
    # padded rows cross ranks both ways on four (the pad's and the crop's
    # exchanges move rows); on two they stay put
    want = jax_refs[case, "jax_propagate"]
    got = gathered(world(4), case)
    assert np.abs(got - want).max() / np.abs(want).max() < REL_TOL


def test_band_limit_matters_at_these_distances(jax_refs):
    masked = jax_refs["band_limit", "jax_propagate"]
    unmasked = np.asarray(jax.jit(functools.partial(jasm._propagate_xla, **KW))(
        jnp.asarray(inputs()["field"]), jnp.asarray(CASES["band_limit"][1])))
    assert np.abs(unmasked - masked).max() / np.abs(masked).max() > 1e-3


@pytest.fixture(scope="module")
def grad_refs(field):
    f = jnp.asarray(field[:1])
    g = jax.jit(jax.grad(lambda x: jnp.sum(jnp.abs(jasm._propagate_xla(x, 4e-4, **KW)) ** 2)))(f)
    x = torch.from_numpy(field[:1]).clone().requires_grad_(True)
    (propagate_torch(x, 4e-4, **KW).abs() ** 2).sum().backward()
    return {"jax": np.conj(np.asarray(g)), "port_one_device": x.grad.numpy()}


@pytest.mark.parametrize("ref", ["jax", "port_one_device"])
@pytest.mark.parametrize("n", [2, 4])
def test_gradient_matches(n, ref, grad_refs):
    want = grad_refs[ref]
    got = np.concatenate([r["fft"]["grad"].numpy() for r in world(n)], axis=-2)
    assert np.abs(got - want).max() / np.abs(want).max() < GRAD_TOL


@pytest.mark.parametrize("n", [2, 4])
def test_indivisible_side_raises(n):
    assert all(r["fft"]["raises"] for r in world(n))


@pytest.mark.parametrize("kind", ["const", "dynamic"])
def test_asm_ops_on_batch_shards_gather_bit_for_bit(kind):
    inp = inputs()
    f = torch.from_numpy(inp["asm_field"])
    d = 5e-4 if kind == "const" else torch.from_numpy(inp["asm_d"])
    want = propagate(f, d, backend="cuda", **KW)
    got = torch.cat([r["asm"][kind] for r in world(2)])
    assert torch.equal(got, want)


def test_fov_sharding_splits_the_rows():
    mesh = make_mesh(devices=["cpu"] * 2)
    sh = fov_sharding(mesh)
    assert sh.spec == (None, None, "data", None)
    assert sh.shard_shape((2, 1, 64, 64)) == (2, 1, 32, 64)
