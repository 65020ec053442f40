"""The port's ablation families (``models/ablations.py``) against the JAX
package's, on the same numpy-seeded variables carried across by
``interop.convert_ablation_variables``, fp32, within 1e-5 of max|ref|:

* ``CBR`` in each norm, down at stride 2 (flax's SAME pad (0, 1)), up at
  stride 2 (flax's ``ConvTranspose``: the unflipped kernel over the
  zero-inserted input padded (2, 1)), with the 7x7 kernel and leaky ReLU;
* batch norm in train mode: the output and the running averages after one
  call (flax's momentum 0.99, the biased variance), then eval mode on them;
* ``ECALayer`` (k 3 and the asymmetric SAME pad of k 4);
* ``HoloEncoder`` + ``HoloDecoder`` at ``base=8``, 32^2, with skips in
  instance norm and without them in batch norm. In instance norm the last
  stage's norm runs over a 2x2 latent, four values a channel, whose
  variance amplifies fp32 rounding: the JAX package's own fp32 latent is
  2.9e-5 of max from its evaluation in float64 (``jax.enable_x64``), the
  port's 6.5e-6 from its own (at 64^2, a 4x4 latent, both under 6e-6). So
  the latent and the output of the instance-norm case are held within
  5e-5 (``DEEP_INSTANCE_TOL``), the taps within 1e-5;
* ``TrivialSolutionNet`` at its only width (1.0) against the JAX module
  at 16^2 (8 s of its worker inside the whole tier-1 run); ``slow``, with
  ``-m ""``: the net at 32^2 and ``HoloAutoEncoder()`` at its full widths.
  The JAX references are jitted (a third of the time of running them op by
  op).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_cpu_threads import warm_few_torch_threads  # noqa: F401

from style_transfer_based_holographic_imaging_tpu.models import ablations as J
from style_transfer_based_holographic_imaging_tpu_torch.interop import convert_ablation_variables
from style_transfer_based_holographic_imaging_tpu_torch.models import ablations as P

TOL = 1e-5
# The port against the JAX package after an instance norm over a 2x2 latent
# (see the module docstring).
DEEP_INSTANCE_TOL = 5e-5


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(x), (0, 3, 1, 2))))


def nhwc(x: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(x.detach().permute(0, 2, 3, 1).numpy())


def rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def seeded_variables(module, *args, seed: int = 0, **kw):
    """The module's variables, shaped by ``jax.eval_shape`` of its ``init``
    (no compile) and drawn with numpy: He-normal kernels (the transposed 2x2
    kernels of the decoder by their ``C_in``), N(0, 0.01^2) biases, scales
    near 1, running means near 0 and variances in [0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), *args, **kw))

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        shape = s.shape
        if name.endswith("['kernel']"):
            fan = shape[0] if (len(shape) == 4 and "['up" in name and shape[-1] == 2) else int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) * np.sqrt(2.0 / fan)).astype(np.float32)
        if name.endswith("['scale']"):
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        if name.endswith("['var']"):
            return (0.5 + rng.random(shape)).astype(np.float32)
        return (0.01 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def port_module(module, variables):
    module.load_state_dict(convert_ablation_variables(variables), strict=True)
    return module


CBR_CASES = {
    "instance": dict(norm="instance"),
    "group": dict(norm="group"),
    "batch": dict(norm="batch"),
    "none_lrelu": dict(norm="none", lrelu=True, slope=0.1),
    "down_stride2_instance": dict(stride=2),
    "down_stride2_group": dict(stride=2, norm="group"),
    "up_stride2": dict(sampling="up", stride=2),
    "up_stride2_batch": dict(sampling="up", stride=2, norm="batch"),
    "kernel7": dict(kernel=7),
}


@pytest.mark.parametrize("kw", CBR_CASES.values(), ids=CBR_CASES.keys())
def test_cbr_matches_flax(kw):
    x = np.random.default_rng(1).standard_normal((2, 8, 8, 4)).astype(np.float32)
    jm = J.CBR(32 if kw.get("norm") == "group" else 8, **kw)
    v = seeded_variables(jm, jnp.asarray(x))
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    pm = port_module(P.CBR(jm.features, **kw), v)
    with torch.no_grad():
        got = nhwc(pm(nchw(x)))
    assert got.shape == want.shape
    assert rel(got, want) < TOL


def test_cbr_paddings_are_flaxs():
    """The two paddings torch's layers would take instead part from flax by
    far: a stride-2 conv padded (1, 1), a ``conv_transpose2d`` padded 1 with
    output padding 1 (kernel flipped or not)."""
    x = np.random.default_rng(2).standard_normal((1, 8, 8, 4)).astype(np.float32)
    for kw in (dict(stride=2), dict(sampling="up", stride=2)):
        jm = J.CBR(8, norm="none", **kw)
        v = seeded_variables(jm, jnp.asarray(x))
        want = nchw(np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x))))
        pm = port_module(P.CBR(8, norm="none", **kw), v)
        w, b = pm.conv.weight.detach(), pm.conv.bias.detach()
        with torch.no_grad():
            assert rel(pm(nchw(x)), want) < TOL
            if kw.get("sampling") == "up":
                for k in (w.transpose(0, 1), w.flip(2, 3).transpose(0, 1)):
                    y = torch.relu(torch.nn.functional.conv_transpose2d(
                        nchw(x), k, b, stride=2, padding=1, output_padding=1))
                    assert rel(y, want) > 0.1
            else:
                y = torch.relu(torch.nn.functional.conv2d(nchw(x), w, b, stride=2, padding=1))
                assert rel(y, want) > 0.1


def test_batch_norm_running_stats_follow_flax():
    x = (np.random.default_rng(3).random((2, 8, 8, 4)) * 3 + 5).astype(np.float32)
    jm = J.CBR(8, norm="batch")
    v = seeded_variables(jm, jnp.asarray(x), train=True)
    want, mutated = jax.jit(functools.partial(jm.apply, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
    pm = port_module(P.CBR(8, norm="batch"), v)
    before = pm.norm.running_mean.clone()
    with torch.no_grad():
        got = pm(nchw(x), train=True)
    assert rel(nhwc(got), want) < TOL
    moved = convert_ablation_variables({"params": v["params"], "batch_stats": jax.device_get(mutated["batch_stats"])})
    for name in ("norm.running_mean", "norm.running_var"):
        assert rel(pm.state_dict()[name], moved[name]) < TOL, name
    assert not torch.allclose(pm.norm.running_mean, before)
    # eval mode reads the moved averages and leaves them
    after = {k: t.clone() for k, t in pm.state_dict().items()}
    want_eval = jax.jit(jm.apply)({"params": v["params"], "batch_stats": mutated["batch_stats"]}, jnp.asarray(x))
    with torch.no_grad():
        assert rel(nhwc(pm(nchw(x))), want_eval) < TOL
    assert all(torch.equal(after[k], t) for k, t in pm.state_dict().items())


@pytest.mark.parametrize("k_size", [3, 4])
def test_eca_matches_flax(k_size):
    x = np.random.default_rng(4).standard_normal((2, 8, 8, 16)).astype(np.float32)
    jm = J.ECALayer(k_size=k_size)
    v = seeded_variables(jm, jnp.asarray(x))
    pm = port_module(P.ECALayer(k_size=k_size), v)
    assert sum(p.numel() for p in pm.parameters()) == k_size
    with torch.no_grad():
        assert rel(nhwc(pm(nchw(x))), jax.jit(jm.apply)(v, jnp.asarray(x))) < TOL


@pytest.mark.parametrize("skip, norm", [(True, "instance"), (False, "batch")])
def test_encoder_decoder_match_flax(skip, norm):
    x = np.random.default_rng(5).standard_normal((2, 32, 32, 1)).astype(np.float32)
    je, jd = J.HoloEncoder(base=8, norm=norm), J.HoloDecoder(base=8, skip=skip, norm=norm)
    ve = seeded_variables(je, jnp.asarray(x), seed=1)
    latent, taps = jax.jit(je.apply)(ve, jnp.asarray(x))
    vd = seeded_variables(jd, latent, taps, seed=2)
    want = jax.jit(jd.apply)(vd, latent, taps)
    pe = port_module(P.HoloEncoder(base=8, norm=norm), ve)
    pd = port_module(P.HoloDecoder(base=8, skip=skip, norm=norm), vd)
    with torch.no_grad():
        p_latent, p_taps = pe(nchw(x))
        got = pd(p_latent, p_taps)
    assert [t.shape[1] for t in p_taps] == [8, 16, 32, 64]
    assert got.shape == (2, 2, 32, 32)
    deep_tol = DEEP_INSTANCE_TOL if norm == "instance" else TOL
    for a, b, tol in zip(p_taps + [p_latent, got], list(taps) + [latent, want], [TOL] * 4 + [deep_tol] * 2):
        assert rel(nhwc(a), b) < tol


@pytest.mark.parametrize("size", [16, pytest.param(32, marks=pytest.mark.slow)])
def test_trivial_solution_net_matches_flax(size):
    x = np.random.default_rng(7).random((2, size, size, 1)).astype(np.float32)
    jm = J.TrivialSolutionNet()
    v = seeded_variables(jm, jnp.asarray(x))
    amp, phase, dist = jax.jit(jm.apply)(v, jnp.asarray(x))
    pm = port_module(P.TrivialSolutionNet(), v)
    with torch.no_grad():
        p_amp, p_phase, p_dist = pm(nchw(x))
    assert rel(nhwc(p_amp), amp) < TOL and rel(nhwc(p_phase), phase) < TOL
    assert rel(p_dist, dist) < TOL


@pytest.mark.slow
def test_holo_autoencoder_matches_flax_at_full_width():
    """At 32^2 the latent is 2x2, as in ``test_encoder_decoder_match_flax``."""
    x = np.random.default_rng(8).random((1, 32, 32, 1)).astype(np.float32)
    for kw in (dict(), dict(skip=False, norm="group")):
        jm = J.HoloAutoEncoder(**kw)
        v = seeded_variables(jm, jnp.asarray(x))
        pm = port_module(P.HoloAutoEncoder(**kw), v)
        assert pm.decoder.up10.conv.weight.shape[0] == 512
        with torch.no_grad():
            got = pm(nchw(x))
        tol = DEEP_INSTANCE_TOL if kw.get("norm", "instance") == "instance" else TOL
        assert rel(nhwc(got), jax.jit(jm.apply)(v, jnp.asarray(x))) < tol, kw
