"""The port's packed (space-to-depth) layers (``kernels/packed_conv.py``)
against the JAX package's functions on the same numpy inputs, NCHW against
NHWC (the mirror of ``tests/test_packed.py``'s seven checks): the shifted
packing bit for bit, one packed reflect conv, a chain through
``repad_packed``, the transposed conv as a matmul, the phase-group pool
(fp32, within 2e-5, that file's tolerance), the int8 packed conv against
the JAX package's int8 packed conv (the int32 sums exact) and near the fp
conv, and an odd size raising."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from style_transfer_based_holographic_imaging_tpu.kernels import packed_conv as J_eager
from style_transfer_based_holographic_imaging_tpu_torch.kernels import packed_conv as P

TOL = 2e-5


class J:
    """The JAX package's functions, jitted (op by op they compile for seconds)."""

    pack_image = staticmethod(jax.jit(J_eager.pack_image))
    pack_kernel = staticmethod(jax.jit(J_eager.pack_kernel))
    repad_packed = staticmethod(jax.jit(J_eager.repad_packed))
    unpack_image = staticmethod(jax.jit(J_eager.unpack_image))
    packed_pool = staticmethod(jax.jit(J_eager.packed_pool))
    packed_deconv = staticmethod(jax.jit(J_eager.packed_deconv, static_argnums=3))
    packed_reflect_conv = staticmethod(jax.jit(J_eager.packed_reflect_conv, static_argnames=("dt", "relu")))


def rand(rng, *shape) -> np.ndarray:
    return rng.standard_normal(shape).astype(np.float32)


def nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(x), (0, 3, 1, 2))))


def oihw(k) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(k, (3, 2, 0, 1))))


def plain_reflect_conv(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor, relu=True) -> torch.Tensor:
    y = F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), k, b)
    return torch.relu(y) if relu else y


def test_pack_image_is_the_jax_packing():
    x = rand(np.random.default_rng(0), 2, 16, 16, 3)
    z = P.pack_image(nchw(x))
    assert z.shape == (2, 12, 9, 9)
    assert torch.equal(z, nchw(J.pack_image(jnp.asarray(x))))
    k = rand(np.random.default_rng(0), 3, 3, 3, 5)
    assert torch.equal(P.pack_kernel(oihw(k)), torch.from_numpy(
        np.ascontiguousarray(np.transpose(np.asarray(J.pack_kernel(jnp.asarray(k))), (3, 2, 0, 1)))))


def test_single_conv_matches_jax():
    rng = np.random.default_rng(1)
    x, k, b = rand(rng, 2, 16, 16, 5), rand(rng, 3, 3, 5, 7) * 0.2, rand(rng, 7) * 0.1
    got = P.unpack_image(P.packed_reflect_conv(P.pack_image(nchw(x)), oihw(k), torch.from_numpy(b),
                                               dt=torch.float32))
    want = J.unpack_image(J.packed_reflect_conv(J.pack_image(jnp.asarray(x)), jnp.asarray(k), jnp.asarray(b),
                                                dt=jnp.float32))
    np.testing.assert_allclose(got.numpy(), nchw(want).numpy(), atol=TOL)
    np.testing.assert_allclose(got.numpy(), plain_reflect_conv(nchw(x), oihw(k), torch.from_numpy(b)).numpy(),
                               atol=TOL)


def test_chain_through_repad_matches_jax():
    rng = np.random.default_rng(2)
    x = rand(rng, 2, 32, 32, 4)
    k1, b1 = rand(rng, 3, 3, 4, 6) * 0.2, rand(rng, 6) * 0.1
    k2, b2 = rand(rng, 3, 3, 6, 8) * 0.2, rand(rng, 8) * 0.1
    y1 = P.packed_reflect_conv(P.pack_image(nchw(x)), oihw(k1), torch.from_numpy(b1), dt=torch.float32)
    z2 = P.repad_packed(y1)
    jy1 = J.packed_reflect_conv(J.pack_image(jnp.asarray(x)), jnp.asarray(k1), jnp.asarray(b1), dt=jnp.float32)
    np.testing.assert_allclose(z2.numpy(), nchw(J.repad_packed(jy1)).numpy(), atol=TOL)
    got = P.unpack_image(P.packed_reflect_conv(z2, oihw(k2), torch.from_numpy(b2), dt=torch.float32, relu=False))
    want = J.unpack_image(J.packed_reflect_conv(J.repad_packed(jy1), jnp.asarray(k2), jnp.asarray(b2),
                                                dt=jnp.float32, relu=False))
    np.testing.assert_allclose(got.numpy(), nchw(want).numpy(), atol=5e-5)


def test_deconv_matches_jax():
    rng = np.random.default_rng(3)
    x, kernel, bias = rand(rng, 2, 8, 8, 6), rand(rng, 6, 10, 2, 2) * 0.3, rand(rng, 10) * 0.1
    got = P.unpack_image(P.packed_deconv(nchw(x), torch.from_numpy(kernel), torch.from_numpy(bias), torch.float32))
    want = J.unpack_image(J.packed_deconv(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias), jnp.float32))
    np.testing.assert_allclose(got.numpy(), nchw(want).numpy(), atol=TOL)
    ref = F.conv_transpose2d(nchw(x), torch.from_numpy(kernel), torch.from_numpy(bias), stride=2)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=TOL)


def test_pool_matches_jax():
    x = rand(np.random.default_rng(4), 2, 16, 16, 6)
    eye = np.zeros((3, 3, 6, 6), np.float32)
    eye[1, 1] = np.eye(6)
    yp = P.packed_reflect_conv(P.pack_image(nchw(x)), oihw(eye), torch.zeros(6), dt=torch.float32, relu=False)
    jyp = J.packed_reflect_conv(J.pack_image(jnp.asarray(x)), jnp.asarray(eye), jnp.zeros((6,)),
                                dt=jnp.float32, relu=False)
    got = P.packed_pool(yp)
    np.testing.assert_allclose(got.numpy(), nchw(J.packed_pool(jyp)).numpy(), atol=TOL)
    np.testing.assert_allclose(got.numpy(), F.max_pool2d(nchw(x), 2, 2).numpy(), atol=TOL)


def test_int8_packed_conv_matches_jax_and_stays_near_fp():
    rng = np.random.default_rng(5)
    x = rng.random((2, 16, 16, 8)).astype(np.float32)
    k, b = rand(rng, 3, 3, 8, 8) * 0.2, rand(rng, 8) * 0.1
    act_max = float(np.abs(x).max())
    z = P.pack_image(nchw(x))
    q = P.unpack_image(P.packed_reflect_conv(z, oihw(k), torch.from_numpy(b), dt=torch.float32,
                                             act_max=torch.tensor(act_max)))
    jq = J.unpack_image(J.packed_reflect_conv(J.pack_image(jnp.asarray(x)), jnp.asarray(k), jnp.asarray(b),
                                              dt=jnp.float32, act_max=jnp.float32(act_max)))
    np.testing.assert_allclose(q.numpy(), nchw(jq).numpy(), rtol=0, atol=1e-6)
    fp = P.unpack_image(P.packed_reflect_conv(z, oihw(k), torch.from_numpy(b), dt=torch.float32))
    err, scale = float((fp - q).abs().max()), float(fp.abs().max())
    assert err < 0.03 * max(scale, 1.0), (err, scale)


def test_odd_size_raises():
    with pytest.raises(RuntimeError):
        P.pack_image(nchw(rand(np.random.default_rng(6), 1, 15, 15, 2)))
