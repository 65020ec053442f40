"""The port's angular-spectrum propagator against the JAX package's.

* the ``torch.fft`` composition against ``ops.asm._propagate_xla``
  (relative error 1e-5 of max|ref|);
* the folded DFT factors bit for bit, the kz grid within 1e-6;
* each CUDA kernel's plain PyTorch version against the Pallas kernel run in
  interpret mode, in each ``set_dft_precision`` mode, with the JAX package's
  budgets (tests/test_pallas.py): 1e-5 highest, 1e-4 high, 2e-2 bf16;
* routing on CPU tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_based_holographic_imaging_tpu.kernels import asm_pallas as jax_pallas
from style_transfer_based_holographic_imaging_tpu.ops import asm as jax_asm
from style_transfer_based_holographic_imaging_tpu_torch.kernels import asm_cuda
from style_transfer_based_holographic_imaging_tpu_torch.ops import asm as torch_asm

KW = dict(wavelength=532e-9, pixel_size=1.5e-6)
BUDGETS = {"highest": 1e-5, "high": 1e-4, "bf16": 2e-2}


def _field(b=2, n=32, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((b, 1, n, n)) + 1j * rng.random((b, 1, n, n))).astype(np.complex64)


def _rel(got, ref):
    return np.abs(np.asarray(got) - np.asarray(ref)).max() / np.abs(np.asarray(ref)).max()


@pytest.fixture
def restore_jax_precision():
    yield
    jax_pallas.set_dft_precision("high")


@pytest.mark.parametrize("n,full", [(16, 32), (32, 64), (128, 256)])
def test_folded_factors_bit_identical(n, full):
    ours = asm_cuda.folded_factors(n, full)
    ref = jax_pallas._folded_factors(n, full)
    assert all(np.array_equal(a, b) for a, b in zip(ours, ref))
    assert all(a.dtype == np.float32 for a in ours)


@pytest.mark.parametrize("h,w", [(32, 32), (64, 48), (256, 256)])
def test_kz_grid_matches(h, w):
    # The port mirrors the fp32 ops of the jitted JAX grid on the host. XLA's
    # CPU code for the vectorized division differs from IEEE division by up
    # to 4 ulp on some elements at 128 and beyond, so the grid is held to
    # 1e-6 of its largest value (bit-identical at the smaller sizes).
    ours = torch_asm.kz_rel_grid(h, w, **KW)
    ref = np.asarray(jax_asm._kz_rel_grid(h, w, **KW))
    assert ours.dtype == np.float32
    assert _rel(ours, ref) < 1e-6


@pytest.mark.parametrize(
    "case",
    ["static", "per_sample", "no_pad", "band_limit", "pad_factor_3"],
)
def test_torch_fft_matches_xla(case):
    f = _field()
    d = np.asarray([3e-4, 7e-4], np.float32).reshape(2, 1, 1, 1)
    kw = dict(KW)
    dist = d
    if case == "static":
        dist = 5e-4
    elif case == "no_pad":
        kw["pad"] = False
    elif case == "band_limit":
        dist = d * 10.0  # 3-7 mm: past the alias-free range, where the limit bites
        kw["band_limit"] = True
    elif case == "pad_factor_3":
        kw["pad_factor"] = 3
    ref = jax_asm._propagate_xla(jnp.asarray(f), dist, **kw)
    got = torch_asm.propagate_torch(
        torch.from_numpy(f), dist if np.isscalar(dist) else torch.from_numpy(dist), **kw
    )
    assert _rel(got.numpy(), ref) < 1e-5


@pytest.mark.parametrize("precision", ["highest", "high", "bf16"])
@pytest.mark.parametrize("variant", ["const", "dynamic"])
def test_plain_versions_match_pallas(precision, variant, restore_jax_precision):
    f = _field(b=2, n=32, seed=3)
    xre = torch.from_numpy(np.ascontiguousarray(f.real[:, 0]))
    xim = torch.from_numpy(np.ascontiguousarray(f.imag[:, 0]))
    jax_pallas.set_dft_precision(precision)
    if variant == "const":
        ref = jax_pallas.propagate_pallas(jnp.asarray(f), 5e-4, **KW, interpret=True)
        yre, yim = asm_cuda.asm_const_plain(xre, xim, 5e-4, precision=precision, **KW)
    else:
        d = np.asarray([3e-4, -7e-4], np.float32)
        ref = jax_pallas.propagate_pallas(
            jnp.asarray(f), jnp.asarray(d.reshape(2, 1, 1, 1)), **KW, interpret=True
        )
        yre, yim = asm_cuda.asm_dynamic_plain(
            xre, xim, torch.from_numpy(d), precision=precision, **KW
        )
    got = (yre + 1j * yim).numpy()[:, None]
    assert _rel(got, ref) < BUDGETS[precision]
    # and the same budget against the exact torch.fft composition
    dist = 5e-4 if variant == "const" else torch.tensor([3e-4, -7e-4]).reshape(2, 1, 1, 1)
    exact = torch_asm.propagate_torch(torch.from_numpy(f), dist, **KW).numpy()
    assert _rel(got, exact) < BUDGETS[precision]


def test_auto_on_cpu_takes_torch_fft():
    f = torch.from_numpy(_field())
    asm_cuda.reset_launches()
    got = torch_asm.propagate(f, 5e-4, **KW)
    want = torch_asm.propagate_torch(f, 5e-4, **KW)
    assert torch.equal(got, want)
    assert asm_cuda.LAUNCHES == {"asm_const": 0, "asm_dynamic": 0}


@pytest.mark.parametrize("distance", ["static", "per_sample"])
def test_cuda_backend_on_cpu_tensor_runs_plain_version(distance):
    f = torch.from_numpy(_field())
    d = 5e-4 if distance == "static" else torch.tensor([3e-4, 7e-4]).reshape(2, 1, 1, 1)
    asm_cuda.reset_launches()
    got = torch_asm.propagate(f, d, backend="cuda", **KW)
    exact = torch_asm.propagate_torch(f, d, **KW)
    assert got.shape == f.shape
    assert _rel(got.numpy(), exact.numpy()) < BUDGETS["high"]
    # the plain version ran: no kernel was launched
    assert asm_cuda.LAUNCHES == {"asm_const": 0, "asm_dynamic": 0}


@pytest.mark.parametrize(
    "shape,kw",
    [
        ((1, 1, 31, 31), {}),
        ((1, 1, 32, 32), {"pad": False}),
        ((1, 1, 32, 32), {"band_limit": True}),
        ((1, 1, 512, 512), {}),
    ],
)
def test_explicit_cuda_on_ineligible_shape_raises(shape, kw):
    f = torch.zeros(shape, dtype=torch.complex64)
    with pytest.raises(ValueError):
        torch_asm.propagate(f, 3e-4, backend="cuda", **KW, **kw)


def test_unknown_backend_raises():
    with pytest.raises(ValueError):
        torch_asm.propagate(torch.zeros(1, 32, 32, dtype=torch.complex64), 3e-4, backend="xla", **KW)


def test_wrappers_check_their_inputs():
    x = torch.zeros(2, 32, 32)
    with pytest.raises(TypeError):
        asm_cuda.asm_const(x.double(), x.double(), 3e-4, **KW)
    with pytest.raises(ValueError):
        asm_cuda.asm_const(x.transpose(1, 2), x, 3e-4, **KW)
    with pytest.raises(ValueError):
        asm_cuda.asm_dynamic(x, x, torch.zeros(3), **KW)
    with pytest.raises(ValueError):
        asm_cuda.asm_const(x, x, 3e-4, precision="fp8", **KW)
    with pytest.raises(ValueError):
        asm_cuda.set_dft_precision("fp8")
