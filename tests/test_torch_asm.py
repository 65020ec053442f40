"""The port's angular-spectrum propagator against the JAX package's.

* the ``torch.fft`` composition against ``ops.asm._propagate_xla``
  (relative error 1e-5 of max|ref|);
* the folded DFT factors bit for bit, the kz grid within 1e-6;
* each CUDA kernel's plain PyTorch version against the Pallas kernel run in
  interpret mode, in each ``set_dft_precision`` mode, with the JAX package's
  budgets (tests/test_pallas.py): 1e-5 highest, 1e-4 high, 2e-2 bf16;
* routing on CPU tensors, and the process-wide backend (``set_asm_backend``,
  ``STHI_ASM_BACKEND``) that ``cli --asm-backend`` sets: a per-call backend
  overrides it, a global ``cuda`` means what a per-call ``cuda`` means, and
  an unknown name raises from the call and from the variable at import.
"""

import os
import subprocess
import sys

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


# --------------------------------------------------------------------------
# The tensor-core kernels' host-side operands (the `high` and `bf16` modes)
# --------------------------------------------------------------------------

TC_SHAPES = [(3, 128, 128), (2, 48, 64), (1, 16, 16)]


@pytest.mark.parametrize("h,w", [(128, 128), (48, 64), (16, 16), (18, 30)])
def test_block_factors_stack_the_folded_factors(h, w):
    """Each block holds the complex factor's planes with re and im stacked
    along K, the right-hand blocks with re and im output columns interleaved."""
    fh, fw = 2 * h, 2 * w
    f1, g2, f3, g4 = asm_cuda.block_factors(h, w)
    are, aim, cre, cim = asm_cuda.folded_factors(h, fh)
    awre, awim, cwre, cwim = asm_cuda.folded_factors(w, fw)
    for block, re, im in ((f1, are, aim), (f3, cre, cim)):
        m, k = re.shape
        assert block.shape == (2 * m, 2 * k) and block.dtype == np.float32
        np.testing.assert_array_equal(block[:m, :k], re)
        np.testing.assert_array_equal(block[:m, k:], -im)
        np.testing.assert_array_equal(block[m:, :k], im)
        np.testing.assert_array_equal(block[m:, k:], re)
    for block, re, im in ((g2, awre, awim), (g4, cwre, cwim)):
        n, k = re.shape
        assert block.shape == (2 * n, 2 * k)
        np.testing.assert_array_equal(block[0::2], np.concatenate([re, -im], 1))
        np.testing.assert_array_equal(block[1::2], np.concatenate([im, re], 1))


@pytest.mark.parametrize("h,w", [(128, 128), (48, 64), (16, 16), (18, 30)])
def test_block_factor_splits_reconstruct_the_factors(h, w):
    """hi + lo gives each factor back to the two-term bf16 split's bound
    (2^-16 of each element); the device planes are the splits, zero-padded
    to a row pitch of 8 elements (16 bytes, the tensor maps' stride unit)."""
    planes = asm_cuda._block_factor_tensors(h, w, torch.device("cpu"))
    for i, m in enumerate(asm_cuda.block_factors(h, w)):
        m = torch.from_numpy(np.array(m))
        hi, lo = asm_cuda.split_hi_lo(m)
        assert hi.dtype == lo.dtype == torch.bfloat16
        assert torch.equal(hi.float(), m.to(torch.bfloat16).float())
        err = (hi.float() + lo.float() - m).abs()
        assert bool((err <= 2.0**-16 * m.abs()).all())
        for plane, want in zip(planes[2 * i : 2 * i + 2], (hi, lo)):
            k = m.shape[1]
            assert plane.shape == (m.shape[0], (k + 7) // 8 * 8) and plane.is_contiguous()
            assert torch.equal(plane[:, :k], want)
            assert not bool(plane[:, k:].float().any())


def _three_pass(a, bt, precision):
    """a (..., M, K) times bt (..., N, K) transposed, on the split operands:
    hi.hi + hi.lo + lo.hi in `high`, hi.hi in `bf16`, summed in fp32."""
    ah, al = (t.float() for t in asm_cuda.split_hi_lo(a))
    bh, bl = (t.float() for t in asm_cuda.split_hi_lo(bt))
    out = torch.matmul(ah, bh.transpose(-1, -2))
    if precision == "high":
        out = out + torch.matmul(ah, bl.transpose(-1, -2)) + torch.matmul(al, bh.transpose(-1, -2))
    return out


def _block_propagate(xre, xim, transfer, phasor, precision):
    """The tensor-core kernels' data flow with torch.matmul: each stage one
    real product of the stacked operands, the epilogues' layouts between."""
    b, h, w = xre.shape
    fh = 2 * h
    f1, g2, f3, g4 = (torch.from_numpy(np.array(m)) for m in asm_cuda.block_factors(h, w))
    xt = torch.cat([xre, xim], 1).transpose(1, 2)          # (b, w, 2h) = x^T, [xr | xi]
    s = _three_pass(f1, xt, precision)                     # (b, 2fh, w) = [S1r; S1i]
    s1 = torch.cat([s[:, :fh], s[:, fh:]], 2)              # (b, fh, 2w) = [S1r | S1i]
    t = _three_pass(s1, g2, precision)                     # (b, fh, 2fw), re/im interleaved
    tr, ti = t[..., 0::2], t[..., 1::2]
    hre, him = transfer
    tr, ti = tr * hre - ti * him, tr * him + ti * hre
    tt = torch.cat([tr, ti], 1).transpose(1, 2)            # (b, fw, 2fh) = T^T, [Tr | Ti]
    u = _three_pass(f3, tt, precision)                     # (b, 2h, fw) = [U1r; U1i]
    u1 = torch.cat([u[:, :h], u[:, h:]], 2)                # (b, h, 2fw)
    y = _three_pass(u1, g4, precision)                     # (b, h, 2w), re/im interleaved
    yr, yi = y[..., 0::2], y[..., 1::2]
    if phasor is None:
        return yr, yi
    gc, gs = phasor
    return yr * gc - yi * gs, yr * gs + yi * gc


@pytest.mark.parametrize("precision", ["high", "bf16"])
@pytest.mark.parametrize("shape", TC_SHAPES)
def test_block_real_products_give_the_plain_versions(shape, precision):
    """The three-pass block-real products on the exact operands the kernels
    load give asm_const_plain / asm_dynamic_plain again within the mode's
    budget: only the order of the fp32 sums differs."""
    b, h, w = shape
    rng = np.random.default_rng(b * h + w)
    xre = torch.from_numpy(rng.random((b, h, w), dtype=np.float32))
    xim = torch.from_numpy(rng.random((b, h, w), dtype=np.float32))
    dist = torch.linspace(-8e-4, 8e-4, b, dtype=torch.float32)
    cpu = torch.device("cpu")
    fh, fw = 2 * h, 2 * w

    d = -2e-4
    transfer = asm_cuda._const_transfer(fh, fw, float(np.float32(d)), KW["wavelength"],
                                        KW["pixel_size"], cpu)
    got = torch.complex(*_block_propagate(xre, xim, transfer, None, precision))
    ref = torch.complex(*asm_cuda.asm_const_plain(xre, xim, d, precision=precision, **KW))
    assert _rel(got, ref) < BUDGETS[precision]

    kz = asm_cuda._kz_tensor(fh, fw, KW["pixel_size"], KW["wavelength"], cpu)
    phase = dist.reshape(b, 1, 1) * kz
    g = dist.reshape(b, 1, 1) * float(np.float32(2.0 * np.pi / KW["wavelength"]))
    got = torch.complex(*_block_propagate(
        xre, xim, (torch.cos(phase), torch.sin(phase)), (torch.cos(g), torch.sin(g)), precision))
    ref = torch.complex(*asm_cuda.asm_dynamic_plain(xre, xim, dist, precision=precision, **KW))
    assert _rel(got, ref) < BUDGETS[precision]


@pytest.mark.parametrize("shape", TC_SHAPES + [(2, 18, 30), (2, 48, 80)])
def test_scratch_holds_both_layouts(shape):
    """Each scratch buffer holds an image's fp32 planes (`highest`) and its
    bf16 operand planes with K padded to 8 (`high`, `bf16`); U1's also x^T."""
    b, h, w = shape
    fh, fw = 2 * h, 2 * w
    p8 = lambda n: (n + 7) // 8 * 8  # noqa: E731
    scratch, yre, yim = asm_cuda._launch_buffers(torch.zeros(b, h, w))
    need_bytes = [
        max(4 * fh * w, 2 * fh * p8(2 * w)),
        max(4 * fh * fw, 2 * fw * p8(2 * fh)),
        max(4 * h * fw, 2 * h * p8(2 * fw), 2 * w * p8(2 * h)),
    ]
    for i, t in enumerate(scratch):
        assert t.dtype == torch.float32 and t.shape[0] == b
        assert t[0].numel() * 4 >= need_bytes[i // 2]
    assert yre.shape == yim.shape == (b, h, w)


@pytest.fixture
def global_backend():
    yield torch_asm.set_asm_backend
    torch_asm.set_asm_backend("auto")


def _recording_cuda(monkeypatch):
    calls = []
    real = asm_cuda.propagate_cuda

    def record(*a, **kw):
        calls.append(a[1])
        return real(*a, **kw)

    monkeypatch.setattr(asm_cuda, "propagate_cuda", record)
    return calls


@pytest.mark.parametrize("name,per_call,routed", [
    ("cuda", None, True), ("torch", None, False), ("auto", None, False),
    ("torch", "cuda", True), ("cuda", "torch", False),
])
def test_global_backend_and_the_per_call_override(global_backend, monkeypatch, name, per_call, routed):
    # On a CPU tensor "cuda" runs the kernels' plain versions; "auto" is torch.fft there.
    calls = _recording_cuda(monkeypatch)
    global_backend(name)
    f = torch.from_numpy(_field())
    got = torch_asm.propagate(f, 5e-4, backend=per_call, **KW)
    assert len(calls) == int(routed)
    exact = torch_asm.propagate_torch(f, 5e-4, **KW)
    if routed:
        assert _rel(got.numpy(), exact.numpy()) < BUDGETS["high"]
    else:
        assert torch.equal(got, exact)


def test_global_cuda_on_an_ineligible_shape_raises(global_backend):
    global_backend("cuda")
    with pytest.raises(ValueError, match="backend='cuda' requires"):
        torch_asm.propagate(torch.zeros(1, 1, 31, 31, dtype=torch.complex64), 3e-4, **KW)


def test_an_unknown_global_backend_raises(global_backend):
    for name in ("xla", "pallas", "CUDA"):
        with pytest.raises(ValueError):
            global_backend(name)
    assert torch_asm._BACKEND == "auto"


@pytest.mark.parametrize("value,ok", [("torch", True), ("CUDA", True), ("pallas", False)])
def test_the_environment_variable_at_import(value, ok):
    code = ("from style_transfer_based_holographic_imaging_tpu_torch.ops import asm; "
            "print(asm._BACKEND)")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=repo, env={**os.environ, "STHI_ASM_BACKEND": value})
    if ok:
        assert res.returncode == 0 and res.stdout.split()[-1] == value.lower()
    else:
        assert res.returncode != 0 and "STHI_ASM_BACKEND" in res.stderr
