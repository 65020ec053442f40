"""The reflect-conv border ring (``kernels/reflect_border.py`` of the port)
and ``ReflectConv``'s border backends against the JAX package.

* the plain ring against ``border_lines_pallas`` (interpret mode) and
  ``border_lines_einsum``, at even and odd H, C = 1 and C > 1, in fp32, to
  1e-5 of max|ref| (fp32 sums in another order). The port's ring is NCHW;
  the JAX ring's rows (B, 2, W, O) and cols (B, H, 2, O) are transposed to
  (B, O, 2, W) and (B, O, H, 2);
* the card kernel's folded taps (``ring_taps``) against the JAX kernel's
  fold, bit for bit, and its GEMM over them against the plain ring, to
  1e-5;
* ``ReflectConv`` under ``einsum`` against the flax ``ReflectConv`` under
  ``einsum`` and against the port's ``matpad``, to 1e-5 of max|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_based_holographic_imaging_tpu.kernels import reflect_border as jrb
from style_transfer_based_holographic_imaging_tpu.models import layers as jlayers
from style_transfer_based_holographic_imaging_tpu_torch.kernels import reflect_border
from style_transfer_based_holographic_imaging_tpu_torch.models import ReflectConv, set_reflect_backend

TOL = 1e-5


def _rel(got, ref):
    return np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max()


def _case(b, c, h, w, o, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, c, h, w)).astype(np.float32)
    k = (rng.standard_normal((o, c, 3, 3)) * 0.3).astype(np.float32)
    return x, k


@pytest.fixture
def backend():
    yield
    set_reflect_backend("auto")
    jlayers.set_reflect_backend("auto")


@pytest.mark.parametrize("shape", [(2, 1, 8, 6, 4), (2, 5, 8, 12, 3), (1, 4, 7, 9, 6)],
                         ids=["C1", "C5", "oddH"])
@pytest.mark.parametrize("against", ["pallas", "einsum"])
def test_plain_ring_matches_jax(shape, against):
    b, c, h, w, o = shape
    x, k = _case(b, c, h, w, o)
    xj, kj = jnp.asarray(np.transpose(x, (0, 2, 3, 1))), jnp.asarray(np.transpose(k, (2, 3, 1, 0)))
    if against == "pallas":
        rows_j, cols_j = jrb.border_lines_pallas(xj, kj, interpret=True)
    else:
        rows_j, cols_j = jrb.border_lines_einsum(xj, kj)
    rows, cols = reflect_border.border_lines_plain(torch.as_tensor(x), torch.as_tensor(k))
    assert tuple(rows.shape) == (b, o, 2, w) and tuple(cols.shape) == (b, o, h, 2)
    assert _rel(rows.numpy(), np.transpose(np.asarray(rows_j), (0, 3, 1, 2))) < TOL
    assert _rel(cols.numpy(), np.transpose(np.asarray(cols_j), (0, 3, 1, 2))) < TOL


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["fp32", "bf16"])
def test_ring_taps_are_the_jax_kernels_fold(dtype):
    """``ring_taps``, the folded taps the card kernel multiplies by, equal
    bit for bit the JAX kernel's ``k_sym``, ``k_mid``, ``kt_sym`` and
    ``kt_mid`` (reflect_border.py:100-107: cast to fp32, then add), with
    the output channels padded with zeros to a multiple of 64."""
    _, k = _case(1, 5, 4, 4, 70, seed=3)
    kj = jnp.asarray(np.transpose(k, (2, 3, 1, 0)), dtype)                 # (3, 3, C, O)
    kd = kj.astype(jnp.float32)
    parts = (kd[0] + kd[2], kd[1], kd[:, 0] + kd[:, 2], kd[:, 1])          # (3, C, O) each
    want = np.concatenate([np.asarray(p) for p in parts]).reshape(2, 6, 5, 70)
    kt = torch.as_tensor(np.array(kj.astype(jnp.float32))).permute(3, 2, 0, 1)
    taps = reflect_border.ring_taps(kt.to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32))
    assert taps.dtype == torch.float32 and tuple(taps.shape) == (2, 6, 5, 128)
    np.testing.assert_array_equal(taps[..., :70].numpy(), want)
    assert not taps[..., 70:].any()


def test_ring_gemm_over_the_folded_taps_is_the_plain_ring():
    """The ring as the card kernel sums it: per orientation one product of
    the folded taps (K = 6 C) with the line values at every ring position,
    each line reflect-padded along its length, positions flattened over
    images, lines and sides (rows (b, side, p), columns (b, p, side)),
    against ``border_lines_plain``."""
    b, c, h, w, o = 3, 4, 5, 7, 6
    x, k = _case(b, c, h, w, o, seed=4)
    xt, kt = torch.as_tensor(x), torch.as_tensor(k)
    taps = reflect_border.ring_taps(kt)[..., :o]                          # (2, 6, C, O)

    def lines(near, edge):  # (B, C, 2, L) each -> K x positions, positions (b, side, p)
        n = near.shape[-1]
        idx = torch.cat([torch.tensor([1]), torch.arange(n), torch.tensor([n - 2])])
        win = [t.index_select(-1, idx).unfold(-1, 3, 1) for t in (near, edge)]   # (B, C, 2, L, 3)
        stacked = torch.stack(win, 1).permute(1, 5, 2, 0, 3, 4)                  # (2, 3, C, B, 2, L)
        return stacked.reshape(6 * c, -1)

    near_r = torch.stack([xt[:, :, 1], xt[:, :, h - 2]], 2)
    edge_r = torch.stack([xt[:, :, 0], xt[:, :, h - 1]], 2)
    rows = (taps[0].reshape(6 * c, o).T @ lines(near_r, edge_r)).reshape(o, b, 2, w).permute(1, 0, 2, 3)
    near_c = torch.stack([xt[..., 1], xt[..., w - 2]], 2)
    edge_c = torch.stack([xt[..., 0], xt[..., w - 1]], 2)
    cols = (taps[1].reshape(6 * c, o).T @ lines(near_c, edge_c)).reshape(o, b, 2, h).permute(1, 0, 3, 2)
    prows, pcols = reflect_border.border_lines_plain(xt, kt)
    assert _rel(rows.numpy(), prows.numpy()) < TOL
    assert _rel(cols.numpy(), pcols.numpy()) < TOL


def test_plain_ring_keeps_the_input_dtype():
    x, k = _case(2, 3, 8, 8, 4)
    rows, cols = reflect_border.border_lines(torch.as_tensor(x).bfloat16(), torch.as_tensor(k).bfloat16())
    assert rows.dtype == cols.dtype == torch.bfloat16
    with pytest.raises(TypeError):
        reflect_border.border_lines(torch.as_tensor(x), torch.as_tensor(k).bfloat16())


@pytest.mark.parametrize("port_backend", ["einsum", "cuda"])
@pytest.mark.parametrize("hw", [(8, 6), (9, 16)])
def test_reflect_conv_backends_match(backend, port_backend, hw):
    h, w = hw
    x, k = _case(2, 3, h, w, 5, seed=1)
    bias = np.random.default_rng(2).standard_normal(5).astype(np.float32)
    conv = ReflectConv(3, 5)
    with torch.no_grad():
        conv.weight.copy_(torch.as_tensor(k))
        conv.bias.copy_(torch.as_tensor(bias))
    set_reflect_backend("matpad")
    with torch.no_grad():
        matpad = conv(torch.as_tensor(x)).numpy()
    set_reflect_backend(port_backend)
    with torch.no_grad():
        got = conv(torch.as_tensor(x)).numpy()

    jlayers.set_reflect_backend("einsum")
    params = {"params": {"kernel": jnp.asarray(np.transpose(k, (2, 3, 1, 0))), "bias": jnp.asarray(bias)}}
    ref = jlayers.ReflectConv(features=5).apply(params, jnp.asarray(np.transpose(x, (0, 2, 3, 1))))
    ref = np.transpose(np.asarray(ref), (0, 3, 1, 2))
    assert _rel(got, ref) < TOL
    assert _rel(got, matpad) < TOL


def test_set_reflect_backend_rejects_unknown_names(backend):
    with pytest.raises(ValueError):
        set_reflect_backend("pallas")
    for name in ("auto", "matpad", "einsum", "cuda"):
        set_reflect_backend(name)
