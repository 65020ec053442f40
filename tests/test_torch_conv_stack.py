"""The fused conv stacks' plain versions (``kernels/conv_stack.py`` of the
port) against the JAX package's Pallas kernels in interpret mode and their
XLA references, on the shapes of tests/test_conv_stack.py.

Tolerances: fp32 ``atol 2e-5``, the JAX package's own budget for the fused
kernels against their references (fp32 sums in another order). bf16 against
the Pallas kernel: one bf16 ulp of max|ref| (2^-8 of it): each layer rounds
to bf16, and a value that its fp32 sum puts on a rounding boundary may round
the other way in the other package and carry into the next layer. bf16
against the XLA references: four ulps of max|ref|, because the references
round each layer twice (the conv sum to bf16, then the bf16 bias add) where
the fused kernels add the fp32 bias before their one rounding, over up to
three layers.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_based_holographic_imaging_tpu.kernels import conv_stack as jcs
from style_transfer_based_holographic_imaging_tpu_torch.interop import convert_params
from style_transfer_based_holographic_imaging_tpu_torch.kernels import conv_stack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BF16_ULP = 2.0**-8


def _k(rng, i, o):
    return (rng.standard_normal((o, i, 3, 3)) * 0.1).astype(np.float32)  # OIHW


def _b(rng, o):
    return (rng.standard_normal(o) * 0.1).astype(np.float32)


def _jax(x_nchw, *layers, fn, dtype):
    args = [jnp.asarray(np.transpose(x_nchw, (0, 2, 3, 1)), dtype)]
    for k, b in layers:
        args += [jnp.asarray(np.transpose(k, (2, 3, 1, 0)), dtype), jnp.asarray(b)]
    return np.transpose(np.asarray(fn(*args), np.float32), (0, 3, 1, 2))


def _port(x, *layers, fn, dtype):
    args = [torch.as_tensor(x).to(dtype)]
    for k, b in layers:
        args += [torch.as_tensor(k).to(dtype), torch.as_tensor(b)]
    out = fn(*args)
    assert out.dtype == dtype
    return out.float().numpy()


def _tail_case(rng):
    b, c, h, w = 3, 8, 12, 16
    x = rng.standard_normal((b, c, h, w)).astype(np.float32)
    return x, (_k(rng, c, c), _b(rng, c)), (_k(rng, c, c), _b(rng, c)), (_k(rng, c, 2), _b(rng, 2))


def _head_case(rng, c):
    b, h, w = 2, 16, 12
    x = rng.random((b, c, h, w)).astype(np.float32)
    return x, (_k(rng, c, 8), _b(rng, 8)), (_k(rng, 8, 8), _b(rng, 8))


def _check(got, ref, dtype, against):
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, atol=2e-5)
    else:
        ulps = 1 if against == "pallas" else 4
        assert np.abs(got - ref).max() <= ulps * BF16_ULP * np.abs(ref).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("against", ["pallas", "reference"])
def test_tail_plain_matches_jax(dtype, against):
    x, *layers = _tail_case(np.random.default_rng(7))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jfn = jcs.fused_conv_tail if against == "pallas" else jcs.conv_tail_reference
    ref = _jax(x, *layers, fn=jfn, dtype=jdt)
    got = _port(x, *layers, fn=conv_stack.fused_conv_tail, dtype=dtype)
    assert got.shape == (3, 2, 12, 16)
    _check(got, ref, dtype, against)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("against", ["pallas", "reference"])
def test_head_plain_matches_jax(dtype, channels, against):
    x, *layers = _head_case(np.random.default_rng(7), channels)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jfn = jcs.fused_encoder_head if against == "pallas" else jcs.encoder_head_reference
    ref = _jax(x, *layers, fn=jfn, dtype=jdt)
    got = _port(x, *layers, fn=conv_stack.fused_encoder_head, dtype=dtype)
    assert got.shape == (2, 8, 8, 6)
    _check(got, ref, dtype, against)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    x, *layers = _tail_case(np.random.default_rng(1))
    args = [torch.as_tensor(x)] + [torch.as_tensor(a) for kb in layers for a in kb]
    conv_stack.reset_launches()
    got = conv_stack.fused_conv_tail(*args)
    assert torch.equal(got, conv_stack.conv_tail_plain(*args))
    assert conv_stack.LAUNCHES == {"fused_encoder_head": 0, "fused_conv_tail": 0}


def test_wrappers_reject_what_the_kernels_do_not_take():
    rng = np.random.default_rng(2)
    x, (k1, b1), (k2, b2) = (torch.as_tensor(a) if not isinstance(a, tuple) else tuple(
        torch.as_tensor(t) for t in a) for a in _head_case(rng, 1))
    with pytest.raises(ValueError):  # odd H
        conv_stack.fused_encoder_head(x[:, :, :15], k1, b1, k2, b2)
    with pytest.raises(TypeError):  # kernel dtype differs from the input's
        conv_stack.fused_encoder_head(x, k1.bfloat16(), b1, k2, b2)
    with pytest.raises(ValueError):  # bias not fp32
        conv_stack.fused_encoder_head(x, k1, b1.double(), k2, b2)
    with pytest.raises(ValueError):  # channels do not chain
        conv_stack.fused_encoder_head(x, k1, b1, k2[:, :4].contiguous(), b2)


@pytest.mark.parametrize("n_tile", [64, 8])
def test_pack_tc_weights_is_the_kernels_block_layout(n_tile):
    """(9, N, C16): tap 3*kh + kw, output channel, input channel; the
    padding to N and to a multiple of 16 channels is zeros."""
    k = torch.as_tensor(_k(np.random.default_rng(3), 24, 10))  # O 10, C 24
    packed = conv_stack.pack_tc_weights(k, n_tile)
    assert packed.shape == (9, n_tile * -(-10 // n_tile), 32) and packed.dtype == k.dtype
    for kh in range(3):
        for kw in range(3):
            assert torch.equal(packed[3 * kh + kw, :10, :24], k[:, :, kh, kw])
    assert not packed[:, 10:].any() and not packed[:, :, 24:].any()


@functools.lru_cache(maxsize=None)
def _flagship_tail():
    """The flagship release's own conv8/9/10 (OIHW, numpy), through
    ``convert_params``."""
    ocp = pytest.importorskip("orbax.checkpoint")
    path = os.path.join(REPO, "checkpoints", "release")
    if not os.path.isdir(path):
        pytest.skip("no flagship release")
    state = convert_params(ocp.StandardCheckpointer().restore(path)["params"])
    return tuple((state[f"decoder.conv{i}.weight"].numpy(), state[f"decoder.conv{i}.bias"].numpy())
                 for i in (8, 9, 10))


def _packed_case(c):
    """x (2, c, 12, 16) and the tail's layers: the flagship's own at c = 64,
    seeded ones at the narrower widths (``turbo``'s 24, ``ultra``'s 16)."""
    rng = np.random.default_rng(c)
    x = rng.random((2, c, 12, 16)).astype(np.float32)
    if c == 64:
        return x, _flagship_tail()
    return x, ((_k(rng, c, c), _b(rng, c)), (_k(rng, c, c), _b(rng, c)), (_k(rng, c, 2), _b(rng, 2)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("c", [16, 24, 64])
def test_packed_tail_matches_plain_version_and_jax(dtype, c):
    """``conv_tail_packed``, the tensor-core tail's product over the packed
    blocks (tap by tap, 16 channels a step, C padded to 16, conv10's N to
    8), against ``conv_tail_plain`` and the JAX package's Pallas tail."""
    x, layers = _packed_case(c)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    got = _port(x, *layers, fn=conv_stack.conv_tail_packed, dtype=dtype)
    assert got.shape == (2, 2, 12, 16)
    plain = _port(x, *layers, fn=conv_stack.conv_tail_plain, dtype=dtype)
    _check(got, plain, dtype, "pallas")
    _check(got, _jax(x, *layers, fn=jcs.fused_conv_tail, dtype=jdt), dtype, "pallas")


def _packed_head_case(c, width):
    """x (2, c, 20, 34), off every pre-pool tile of the bf16 head, and a
    conv1_1 / conv1_2 pair at ``width``."""
    rng = np.random.default_rng(10 * c + width)
    x = rng.random((2, c, 20, 34)).astype(np.float32)
    k2 = (rng.standard_normal((width, width, 3, 3)) * (2.0 / (9 * width)) ** 0.5).astype(np.float32)
    return x, (_k(rng, c, width), _b(rng, width)), (k2, _b(rng, width))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("width", [16, 24, 48, 64])
def test_packed_head_matches_plain_version_and_jax(dtype, channels, width):
    """``encoder_head_packed``, the tensor-core head's sums (conv1_1 tap by
    tap per channel, conv1_2 over the packed blocks 16 channels a step, one
    rounding a layer, the pool of rounded values), against the JAX
    package's Pallas head (the file's tolerances) and ``encoder_head_plain``
    (fp32 atol 2e-5; bf16 one bf16 spacing at max|ref|, 2^(floor(log2
    max|ref|) - 7): with three input channels the plain version's conv1_1
    is the library's conv, whose other summation order can put a value on
    the other side of a rounding boundary), at the releases' widths and an
    H x W off the kernel's tiles."""
    x, *layers = _packed_head_case(channels, width)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    got = _port(x, *layers, fn=conv_stack.encoder_head_packed, dtype=dtype)
    assert got.shape == (2, width, 10, 17)
    plain = _port(x, *layers, fn=conv_stack.encoder_head_plain, dtype=dtype)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, plain, atol=2e-5)
    else:  # one bf16 spacing at max|ref|: a flipped rounding of the largest values
        spacing = 2.0 ** (np.floor(np.log2(np.abs(plain).max())) - 7)
        assert np.abs(got - plain).max() <= spacing
    _check(got, _jax(x, *layers, fn=jcs.fused_encoder_head, dtype=jdt), dtype, "pallas")


def test_packed_head_sums_one_channel_as_the_broadcast_branch():
    """With one input channel conv1_1's sums are the JAX kernel's, bit for
    bit in bf16: its tap order, each exact bf16 x bf16 product added in
    fp32, the bias, one rounding. The tensor-core head's conv1_1 sums so."""
    x, (k1, b1), _ = _packed_head_case(1, 64)
    xt, kt = torch.as_tensor(x).bfloat16(), torch.as_tensor(k1).bfloat16()
    ident = torch.zeros(64, 64, 3, 3, dtype=torch.bfloat16)
    ident[torch.arange(64), torch.arange(64), 1, 1] = 1
    zero = torch.zeros(64)
    # conv1_2 as the identity: the pool of conv1_1's rounded output
    got = conv_stack.encoder_head_packed(xt, kt, torch.as_tensor(b1), ident, zero)
    jx = jnp.asarray(np.transpose(x, (0, 2, 3, 1)), jnp.bfloat16)
    jk = jnp.asarray(np.transpose(k1, (2, 3, 1, 0)), jnp.bfloat16)
    conv1 = jcs._conv3x3(jx, jk, jnp.asarray(b1), relu=True)
    ref = np.transpose(np.asarray(jcs._pool2x2(conv1), np.float32), (0, 3, 1, 2))
    np.testing.assert_array_equal(got.float().numpy(), ref)
