"""The port's native unwrap (``ops/unwrap_native.py``) and the DCT switches
of its ``ops/unwrap.py`` against the JAX package's (the mirror of
``tests/test_unwrap.py``'s native and DCT-backend checks):

* the native library loads; it unwraps a ramp exactly, agrees with the
  port's DCT unwrap on a wrapped bump, keeps batched shapes congruent; when
  the committed library does not load it builds ``native/unwrap.cc`` into
  the port's build directory, never into ``native/``, and when that fails
  too it raises;
* ``fft`` (one FFT a DCT, Makhoul's reordering) against the JAX package's
  ``fft`` backend (``jax.scipy.fft.dctn``), on a 600x600 and a 64x64 field,
  within 1e-5 of max before the snap; ``auto`` takes the matmul at 64 and
  the FFT at 600; the DCT pair against ``scipy.fft``;
* ``set_dct_precision("high")`` congruent-equal to ``highest``; unknown
  values raise.

Every test restores both packages' process-wide switches.
"""

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.fft
import torch

from style_transfer_based_holographic_imaging_tpu.ops import unwrap as JU
from style_transfer_based_holographic_imaging_tpu_torch.ops import unwrap as PU
from style_transfer_based_holographic_imaging_tpu_torch.ops import unwrap_native as PN

TOL = 1e-5


@pytest.fixture(autouse=True)
def restore_switches():
    yield
    JU.set_dct_backend("auto")
    JU.set_dct_precision("highest")
    PU.set_dct_backend("auto")
    PU.set_dct_precision("highest")


def wrapped_bump(n: int) -> np.ndarray:
    """A wrapped phase (1, n, n): a bump of 18 rad on a tilted saddle."""
    y, x = np.mgrid[0:n, 0:n].astype(np.float32) / n
    true = 18.0 * np.exp(-((x - 0.4) ** 2 + (y - 0.55) ** 2) / 0.05) + 6.0 * x * y
    return np.angle(np.exp(1j * true)).astype(np.float32)[None]


def rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_native_available():
    assert PN.native_available()


def test_native_ramp_exact():
    y, x = np.mgrid[0:96, 0:96].astype(np.float32)
    true = 0.2 * x + 0.11 * y
    wrapped = np.angle(np.exp(1j * true)).astype(np.float32)
    d = PN.unwrap_phase_native(wrapped) - true
    assert np.abs(d - d.mean()).max() < 1e-5


def test_native_agrees_with_the_dct_unwrap():
    y, x = np.mgrid[0:64, 0:64].astype(np.float32)
    true = 9.0 * np.exp(-(((x - 32) / 14) ** 2 + ((y - 32) / 14) ** 2))
    wrapped = np.angle(np.exp(1j * true)).astype(np.float32)
    a = PN.unwrap_phase_native(torch.from_numpy(wrapped[None, None]))[0, 0]
    b = PU.unwrap_phase(torch.from_numpy(wrapped[None, None]))[0, 0].numpy()
    d = a - b
    assert np.abs(d - d.mean()).max() < 0.05


def test_native_batched_shapes():
    x = np.random.default_rng(0).uniform(-np.pi, np.pi, size=(3, 1, 16, 16)).astype(np.float32)
    out = PN.unwrap_phase_native(x)
    assert out.shape == x.shape and out.dtype == np.float32
    k = (out - x) / (2 * np.pi)
    np.testing.assert_allclose(k, np.round(k), atol=1e-4)


def test_native_builds_its_own_copy_and_raises_when_it_cannot(tmp_path, monkeypatch):
    """The committed library is replaced by a path that does not load: the
    source is built into the build directory; a source that does not
    compile makes the unwrap raise, with no other unwrap in its place."""
    wrapped = wrapped_bump(32)
    want = PN.unwrap_phase_native(wrapped)
    native_dir = pathlib.Path(PN._REPO_ROOT, "native")
    native_before = sorted(p.name for p in native_dir.iterdir())
    monkeypatch.setattr(PN, "_LIB", str(tmp_path / "missing.so"))
    monkeypatch.setattr(PN, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(PN, "_lib", None)
    monkeypatch.setattr(PN, "_error", None)
    np.testing.assert_array_equal(PN.unwrap_phase_native(wrapped), want)
    assert [p.name for p in (tmp_path / "build").iterdir()][0].startswith("libunwrap-")
    broken = tmp_path / "broken.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(PN, "_SRC", str(broken))
    monkeypatch.setattr(PN, "_lib", None)
    monkeypatch.setattr(PN, "_error", None)
    assert not PN.native_available()
    with pytest.raises(RuntimeError, match="native unwrap unavailable"):
        PN.unwrap_phase_native(wrapped)
    assert sorted(p.name for p in native_dir.iterdir()) == native_before


@pytest.mark.parametrize("n", [64, 600])
def test_fft_backend_matches_the_jax_fft_backend(n):
    wrapped = wrapped_bump(n)
    JU.set_dct_backend("fft")
    want = np.asarray(jax.jit(functools.partial(JU.unwrap_phase, congruent=False))(jnp.asarray(wrapped)))
    PU.set_dct_backend("fft")
    got = PU.unwrap_phase(torch.from_numpy(wrapped), congruent=False)
    assert rel(got, want) < TOL
    PU.set_dct_backend("matmul")
    assert rel(PU.unwrap_phase(torch.from_numpy(wrapped), congruent=False), want) < TOL
    PU.set_dct_backend("auto")
    auto = PU.unwrap_phase(torch.from_numpy(wrapped), congruent=False)
    PU.set_dct_backend("matmul" if n <= 512 else "fft")
    assert torch.equal(auto, PU.unwrap_phase(torch.from_numpy(wrapped), congruent=False))


@pytest.mark.parametrize("n", [5, 64, 601])
def test_fft_dct_pair_matches_scipy(n):
    x = np.random.default_rng(n).standard_normal((2, 3, n)).astype(np.float32)
    want = scipy.fft.dct(x.astype(np.float64), type=2, norm="ortho", axis=-1)
    assert rel(PU._dct_last(torch.from_numpy(x)), want) < TOL
    assert rel(PU._idct_last(torch.from_numpy(want.astype(np.float32))), x) < TOL
    x2 = np.random.default_rng(n).standard_normal((2, n, 7)).astype(np.float32)
    PU.set_dct_backend("fft")
    want2 = scipy.fft.dctn(x2.astype(np.float64), type=2, norm="ortho", axes=(-2, -1))
    assert rel(PU._dct2(torch.from_numpy(x2), inverse=False), want2) < TOL
    assert rel(PU._dct2(torch.from_numpy(want2.astype(np.float32)), inverse=True), x2) < TOL


def test_high_precision_is_congruent_equal_to_highest():
    wrapped = torch.from_numpy(np.concatenate([wrapped_bump(64), wrapped_bump(64)[:, ::-1].copy()]))
    PU.set_dct_backend("matmul")
    PU.set_dct_precision("high")
    hi, hi_raw = PU.unwrap_phase(wrapped), PU.unwrap_phase(wrapped, congruent=False)
    PU.set_dct_precision("highest")
    ref, ref_raw = PU.unwrap_phase(wrapped), PU.unwrap_phase(wrapped, congruent=False)
    assert torch.equal(hi, ref)
    assert 0 < rel(hi_raw, ref_raw) < 1e-4  # three bf16 products: close, not equal
    k = ((hi - wrapped) / (2 * np.pi)).numpy()
    np.testing.assert_allclose(k, np.round(k), atol=1e-4)
    JU.set_dct_precision("high")
    jax_high = jax.jit(JU.unwrap_phase)(jnp.asarray(wrapped.numpy()))
    np.testing.assert_allclose(np.asarray(jax_high), hi.numpy(), atol=1e-5)


def test_bad_switch_values_raise():
    with pytest.raises(ValueError, match="dct backend"):
        PU.set_dct_backend("cufft")
    with pytest.raises(ValueError, match="dct precision"):
        PU.set_dct_precision("bf16")
