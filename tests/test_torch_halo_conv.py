"""The halo row-block tail's plain versions (``kernels/halo_conv.py`` of the
port) and the port's ``conv_tail_reference`` against the JAX package's
``halo_conv_tail``/``halo_conv_tail_static`` in interpret mode and its XLA
``conv_tail_reference``, on the shapes of tests/test_halo_conv.py.

Tolerances: fp32 ``atol 2e-5``, the JAX package's own budget (fp32 sums in
another order). bf16 in ulps of max|ref|, by the rule of
tests/test_torch_conv_stack.py: the interior rows within one ulp of the
Pallas kernel (both round each layer once, after the fp32 bias; a value that
one package's fp32 sum puts on a rounding boundary may round the other way
and carry into the next layer), within four ulps of the XLA reference, which
rounds each layer twice (the conv sum, then the bf16 bias add), over three
layers. The 4 + 4 edge rows come from reference strips in both packages:
four ulps. One ulp of max|ref| is bf16's spacing there,
2^(floor(log2 max|ref|) - 7), which lies between 2^-8 and 2^-7 of max|ref|.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_based_holographic_imaging_tpu.kernels import conv_stack as jcs
from style_transfer_based_holographic_imaging_tpu.kernels import halo_conv as jhalo
from style_transfer_based_holographic_imaging_tpu_torch.interop import convert_params
from style_transfer_based_holographic_imaging_tpu_torch.kernels import conv_stack, halo_conv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EDGE = halo_conv.EDGE
VARIANTS = {
    "dynamic": (halo_conv.halo_conv_tail, jhalo.halo_conv_tail),
    "static": (halo_conv.halo_conv_tail_static, jhalo.halo_conv_tail_static),
}


def _layers(rng, c, widths=(8, 8, 2)):
    """(OIHW kernel, bias) per layer, scaled as tests/test_halo_conv.py's."""
    layers = []
    for o in widths:
        layers.append(((rng.standard_normal((o, c, 3, 3)) * 0.2).astype(np.float32),
                       (rng.standard_normal(o) * 0.2).astype(np.float32)))
        c = o
    return layers


def _jax(fn, x, layers, dtype, **kw):
    args = [jnp.asarray(np.transpose(x, (0, 2, 3, 1)), dtype)]
    for k, b in layers:
        args += [jnp.asarray(np.transpose(k, (2, 3, 1, 0)), dtype), jnp.asarray(b)]
    return np.transpose(np.asarray(fn(*args, **kw), np.float32), (0, 3, 1, 2))


def _port(fn, x, layers, dtype, **kw):
    args = [torch.as_tensor(x).to(dtype)]
    for k, b in layers:
        args += [torch.as_tensor(k).to(dtype), torch.as_tensor(b)]
    out = fn(*args, **kw)
    assert out.dtype == dtype
    return out.float().numpy()


def _case(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    return x, _layers(rng, shape[1])


def _ulp(ref):
    """The bf16 ulp of max|ref|."""
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def _check_bf16(got, ref, against):
    """Interior and edge rows to their own budgets (module docstring)."""
    ulp = _ulp(ref)
    interior = slice(EDGE, got.shape[2] - EDGE)
    edges = np.r_[0:EDGE, got.shape[2] - EDGE : got.shape[2]]
    inner_ulps = 1 if against == "pallas" else 4
    assert np.abs(got[:, :, interior] - ref[:, :, interior]).max() <= inner_ulps * ulp
    assert np.abs(got[:, :, edges] - ref[:, :, edges]).max() <= 4 * ulp


@functools.lru_cache(maxsize=None)
def _jax_ref(variant, against, dtype_name, bh, shape, seed):
    x, layers = _case(shape, seed)
    jdt = jnp.float32 if dtype_name == "fp32" else jnp.bfloat16
    if against == "pallas":
        return _jax(VARIANTS[variant][1], x, layers, jdt, bh=bh, interpret=True)
    return _jax(jcs.conv_tail_reference, x, layers, jdt)


@pytest.mark.parametrize("against", ["pallas", "reference"])
@pytest.mark.parametrize("variant", ["dynamic", "static"])
@pytest.mark.parametrize("bh", [8, 24])
def test_halo_tail_fp32_matches_jax(bh, variant, against):
    shape = (2, 8, 56, 32)
    x, layers = _case(shape, 1)
    ref = _jax_ref(variant, against, "fp32", bh, shape, 1)
    got = _port(VARIANTS[variant][0], x, layers, torch.float32, bh=bh)
    assert got.shape == (2, 2, 56, 32)
    np.testing.assert_allclose(got, ref, atol=2e-5)


@pytest.mark.parametrize("against", ["pallas", "reference"])
@pytest.mark.parametrize("variant", ["dynamic", "static"])
def test_halo_tail_bf16_matches_jax(variant, against):
    shape = (1, 8, 40, 32)
    x, layers = _case(shape, 2)
    ref = _jax_ref(variant, against, "bf16", 16, shape, 2)
    got = _port(VARIANTS[variant][0], x, layers, torch.bfloat16, bh=16)
    _check_bf16(got, ref, against)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_conv_tail_reference_matches_jax(dtype):
    x, layers = _case((2, 8, 12, 16), 3)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = _jax(jcs.conv_tail_reference, x, layers, jdt)
    got = _port(conv_stack.conv_tail_reference, x, layers, dtype)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, atol=2e-5)
    else:
        assert np.abs(got - ref).max() <= 4 * _ulp(ref)


def test_interior_is_the_fused_tail_on_those_rows():
    """VALID in H over real rows is the reflect-padded tail: the plain
    interior equals ``conv_tail_plain`` on rows 4..H-5 (one rounding each)."""
    x, layers = _case((2, 8, 40, 24), 4)
    for dtype in (torch.float32, torch.bfloat16):
        args = [torch.as_tensor(x).to(dtype)] + [
            torch.as_tensor(a).to(dtype if a.ndim == 4 else torch.float32)
            for kb in layers for a in kb
        ]
        inner = halo_conv.halo_interior_plain(*args, bh=16)
        whole = conv_stack.conv_tail_plain(*args)
        tol = 2e-5 if dtype == torch.float32 else _ulp(whole.float().numpy())
        assert float((inner.float() - whole[:, :, EDGE:-EDGE].float()).abs().max()) <= tol


def _args(shape=(1, 8, 56, 32), seed=5):
    x, layers = _case(shape, seed)
    return [torch.as_tensor(x)] + [torch.as_tensor(a) for kb in layers for a in kb]


@pytest.mark.parametrize("variant", ["dynamic", "static"])
def test_wrappers_take_the_plain_version_on_the_cpu(variant):
    args = _args()
    halo_conv.reset_launches()
    got = VARIANTS[variant][0](*args, bh=24)
    assert torch.equal(got, halo_conv.halo_conv_tail_plain(*args, bh=24))
    assert halo_conv.LAUNCHES == {"halo_conv_tail": 0, "halo_conv_tail_static": 0}


@pytest.mark.parametrize("variant", ["dynamic", "static"])
def test_wrappers_reject_bad_arguments(variant):
    fn = VARIANTS[variant][0]
    args = _args()
    with pytest.raises(ValueError):  # 48 interior rows do not split into 17
        fn(*args, bh=17)
    with pytest.raises(ValueError):
        fn(*args, bh=0)
    short = _args(shape=(1, 8, 9, 32))
    with pytest.raises(ValueError):  # H < 10: no room for the strips
        fn(*short, bh=1)
    with pytest.raises(TypeError):  # kernel dtype differs from the input's
        fn(args[0], args[1].bfloat16(), *args[2:], bh=24)


def test_static_tail_takes_its_instantiated_block_heights_on_the_cpu_too():
    args = _args()  # 48 interior rows: bh 12 divides them, no static instance
    with pytest.raises(ValueError):
        halo_conv.halo_conv_tail_static(*args, bh=12)
    got = halo_conv.halo_conv_tail(*args, bh=12)
    np.testing.assert_array_equal(got.numpy(), halo_conv.halo_conv_tail_plain(*args, bh=12).numpy())


RELEASES = {"flagship": "checkpoints/release", "ultra": "checkpoints/ultra/release"}


@functools.lru_cache(maxsize=None)
def _release_tail(name):
    """conv8/9/10 of a release, converted to OIHW by ``convert_params``."""
    ocp = pytest.importorskip("orbax.checkpoint")
    path = os.path.join(REPO, RELEASES[name])
    if not os.path.isdir(path):
        pytest.skip(f"no {name} release")
    state = convert_params(ocp.StandardCheckpointer().restore(path)["params"])
    return [(state[f"decoder.conv{i}.weight"].numpy(), state[f"decoder.conv{i}.bias"].numpy())
            for i in (8, 9, 10)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("release", sorted(RELEASES))
def test_release_tail_weights_through_both_packages(release, dtype):
    layers = _release_tail(release)
    c = layers[0][0].shape[1]
    assert c == {"flagship": 64, "ultra": 16}[release]
    rng = np.random.default_rng(6)
    x = rng.random((1, c, 40, 32)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    for port_fn, jax_fn in VARIANTS.values():
        ref = _jax(jax_fn, x, layers, jdt, bh=16, interpret=True)
        got = _port(port_fn, x, layers, dtype, bh=16)
        if dtype == torch.float32:
            np.testing.assert_allclose(got, ref, atol=2e-5)
        else:
            _check_bf16(got, ref, "pallas")
