"""Physics refinement of the port against the JAX package's: the ASM
ops' gradients, ``tv_loss`` and ``physics_refine``.

The same seeded numpy inputs go through both packages on the CPU.

* (a) The ops ``asm_const`` and ``asm_dynamic``, called directly on CPU tensors (their
  forward is then the kernels' plain version): field and distance gradients
  of a real loss against the JAX package's ``propagate_pallas(...,
  interpret=True)`` gradients, rtol 1e-3 / atol 1e-4 (the budgets of
  tests/test_pallas.py), and against the port's own ``propagate_torch``
  autograd to 1e-5 of the largest gradient (``highest``, where the plain
  forward is fp32).
* (b) ``tv_loss`` (order 1, no ``norm``, the form refinement uses) at four
  shapes: rtol 1e-6.
* (c) ``physics_refine`` on golden batch 10 from the GT phase plus 0.3 rad
  of seeded noise at the true distances, 10 and 100 steps, with and without
  ``refine_distance``: PSNR within 0.05 dB of the JAX package's, the
  per-sample residual within 1e-3, the refined phase within 1e-3 rad in the
  mean over its pixels and, at 10 steps, in its 99th percentile (1e-2 at
  100 steps), the distances within 1e-3. Not every pixel: Adam divides each
  pixel's gradient by its own running RMS, so a pixel whose gradient is
  near zero moves by about the step size in a direction set by rounding, and
  the two FFT libraries round apart (the per-pixel maximum reaches 1e-2 at
  10 steps and 1e-2 to 5e-2 rad at 100; ROADMAP C logs the miss).

The golden suite's refine option, autofocus and the flagship release
refined are ``tests/test_torch_refine_suite.py``: the two files run on two
workers of the suite. Both run torch at two threads
(``tests/torch_cpu_threads.py``): under the suite's six workers torch's
default eight wait on cores other workers hold.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_cpu_threads import warm_few_torch_threads  # noqa: F401

from style_transfer_based_holographic_imaging_tpu.config import ExperimentConfig as JConfig
from style_transfer_based_holographic_imaging_tpu.kernels import asm_pallas as jax_pallas
from style_transfer_based_holographic_imaging_tpu.pipelines.refine import physics_refine as j_refine
from style_transfer_based_holographic_imaging_tpu.train.losses import tv_loss as j_tv_loss
from style_transfer_based_holographic_imaging_tpu_torch import ExperimentConfig
from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite
from style_transfer_based_holographic_imaging_tpu_torch.eval import metrics as tmetrics
from style_transfer_based_holographic_imaging_tpu_torch.kernels import asm_cuda
from style_transfer_based_holographic_imaging_tpu_torch.ops import asm as torch_asm
from style_transfer_based_holographic_imaging_tpu_torch.ops import holo_forward
from style_transfer_based_holographic_imaging_tpu_torch.pipelines import physics_refine
from style_transfer_based_holographic_imaging_tpu_torch.train import tv_loss

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(wavelength=532e-9, pixel_size=1.5e-6)
with open(os.path.join(REPO, "checkpoints", "config.json")) as _f:
    CONFIG_TEXT = _f.read()
CFG = ExperimentConfig.from_json(CONFIG_TEXT)
JCFG = JConfig.from_json(CONFIG_TEXT)


# --------------------------------------------------------------------------
# (a) The Functions' gradients
# --------------------------------------------------------------------------


def _planes(b=2, n=32, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((b, n, n)).astype(np.float32), rng.random((b, n, n)).astype(np.float32),
            rng.standard_normal((2, b, n, n)).astype(np.float32))


def _loss_weights(w):
    """A real loss of (yre, yim) that weighs re, im and |y|^2 apart."""
    def loss(yre, yim, lib):
        wre, wim = lib.asarray(w[0]), lib.asarray(w[1])
        return lib.sum(wre * yre + wim * yim * yim + 0.3 * (yre * yre + yim * yim) ** 2)
    return loss


def _port_grads(fn, xre, xim, dist, loss):
    xre, xim = (torch.tensor(t, requires_grad=True) for t in (xre, xim))
    inputs = [xre, xim]
    if isinstance(dist, np.ndarray):
        dist = torch.tensor(dist, requires_grad=True)
        inputs.append(dist)
    yre, yim = fn(xre, xim, dist)
    grads = torch.autograd.grad(loss(yre, yim, torch), inputs)
    return [g.numpy() for g in grads]


def _jax_grads(xre, xim, dist, loss):
    """Gradients through the JAX package's Pallas kernel in interpret mode
    (its custom_vjp), for (xre, xim) and an array distance."""
    per_sample = isinstance(dist, np.ndarray)

    def f(xre, xim, d):
        y = jax_pallas.propagate_pallas(jax.lax.complex(xre, xim)[:, None], d, **KW, interpret=True)
        return loss(jnp.real(y[:, 0]), jnp.imag(y[:, 0]), jnp)

    d = jnp.asarray(dist.reshape(-1, 1, 1, 1)) if per_sample else dist
    argnums = (0, 1, 2) if per_sample else (0, 1)
    grads = jax.grad(f, argnums=argnums)(jnp.asarray(xre), jnp.asarray(xim), d)
    return [np.asarray(g).reshape(-1, *xre.shape[1:]) if i < 2 else np.asarray(g).reshape(-1)
            for i, g in enumerate(grads)]


def _torch_grads(xre, xim, dist, loss):
    def fn(xre, xim, d):
        dd = d.reshape(-1, 1, 1) if isinstance(d, torch.Tensor) else d
        y = torch_asm.propagate_torch(torch.complex(xre, xim), dd, **KW)
        return y.real, y.imag
    return _port_grads(fn, xre, xim, dist, loss)


def _function(kind, precision):
    if kind == "const":
        return lambda xre, xim, d: asm_cuda.asm_const(xre, xim, d, precision=precision, **KW)
    return lambda xre, xim, d: asm_cuda.asm_dynamic(xre, xim, d, precision=precision, **KW)


@pytest.fixture
def jax_precision():
    """The JAX kernel's DFT precision for one test, restored after."""
    def set_(precision):
        jax_pallas.set_dft_precision(precision)
    yield set_
    jax_pallas.set_dft_precision("high")


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("kind", ["const", "dynamic"])
def test_function_gradients_match_jax_custom_vjp(kind, precision, jax_precision):
    jax_precision(precision)
    xre, xim, w = _planes()
    dist = 5e-4 if kind == "const" else np.asarray([3e-4, -7e-4], np.float32)
    loss = _loss_weights(w)
    got = _port_grads(_function(kind, precision), xre, xim, dist, loss)
    ref = _jax_grads(xre, xim, dist, loss)
    assert len(got) == len(ref) == (2 if kind == "const" else 3)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=1e-3, atol=1e-4 * np.abs(r).max())


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("kind", ["const", "dynamic"])
def test_function_gradients_match_torch_fft_autograd(kind, precision):
    """A loss linear in (yre, yim) gives the backward cotangents that do not
    depend on the forward's rounding, so the Functions' gradients are the
    ``propagate_torch`` VJP itself, in every precision of the forward."""
    xre, xim, w = _planes(seed=3)
    dist = -2e-4 if kind == "const" else np.asarray([5e-4, 8e-4], np.float32)

    def loss(yre, yim, lib):
        return lib.sum(lib.asarray(w[0]) * yre + lib.asarray(w[1]) * yim)

    got = _port_grads(_function(kind, precision), xre, xim, dist, loss)
    ref = _torch_grads(xre, xim, dist, loss)
    assert len(got) == len(ref) == (2 if kind == "const" else 3)
    for g, r in zip(got, ref):
        assert np.abs(g - r).max() <= 1e-5 * np.abs(r).max()


@pytest.mark.parametrize("h,w", [(16, 16), (32, 48), (18, 34)])
def test_fold_edges_is_the_replicate_pad_adjoint(h, w):
    """The backward's pad adjoint against autograd of ``pad_replicate``, to
    the rounding of fp32 sums taken in another order (a corner sums
    (h/2 + 1)(w/2 + 1) values)."""
    rng = np.random.default_rng(h + w)
    x = torch.tensor(rng.standard_normal((2, h, w)).astype(np.float32), requires_grad=True)
    g = torch.tensor(rng.standard_normal((2, 2 * h, 2 * w)).astype(np.float32))
    ref, = torch.autograd.grad(torch_asm.pad_replicate(x, h // 2, w // 2), x, g)
    got = asm_cuda._fold_edges(asm_cuda._fold_edges(g, w, 2), h, 1)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_dynamic_function_gives_the_distance_gradient_alone(precision):
    """Refinement's first stage moves the distance alone: planes that need
    no gradient, the distance's as ``propagate_torch`` autograd gives it."""
    xre, xim, w = _planes(seed=7)
    d = np.asarray([4e-4, -6e-4], np.float32)
    fn = _function("dynamic", precision)
    grads = {}
    for name, f in (("fn", fn), ("torch", None)):
        dist = torch.tensor(d, requires_grad=True)
        if f is None:
            y = torch_asm.propagate_torch(torch.complex(torch.tensor(xre), torch.tensor(xim)),
                                          dist.reshape(-1, 1, 1), **KW)
            yre, yim = y.real, y.imag
        else:
            yre, yim = f(torch.tensor(xre), torch.tensor(xim), dist)
        loss = (torch.tensor(w[0]) * yre + torch.tensor(w[1]) * yim).sum()
        grads[name], = torch.autograd.grad(loss, dist)
    assert float((grads["fn"] - grads["torch"]).abs().max()) <= 1e-5 * float(grads["torch"].abs().max())


@pytest.fixture
def port_precision():
    """The port's DFT precision for one test, restored after."""
    yield asm_cuda.set_dft_precision
    asm_cuda.set_dft_precision("high")


@pytest.mark.parametrize("precision", ["high", "highest"])
def test_propagate_is_differentiable_through_the_cuda_backend_on_cpu(precision, port_precision):
    """``backend='cuda'`` on a CPU tensor runs the plain versions inside the
    Functions; its gradients of a real loss of the intensity are the torch
    backend's to rtol 1e-3 of the largest, the JAX package's gradient
    budget. The distance's in ``highest``: the loss weighs the intensity by
    signed weights, and the sum over the pixels cancels to about 1e-3 of its
    terms, so the ``high`` forward's rounding (1e-5 of the field) moves it
    by about 1e-3."""
    port_precision(precision)
    xre, xim, w = _planes(seed=5)
    amp = torch.tensor(xre, requires_grad=True)
    d = torch.tensor([[[[4e-4]]], [[[6e-4]]]], requires_grad=True)
    grads = {}
    for backend in ("cuda", "torch"):
        field = torch.polar(amp, torch.tensor(xim))[:, None]
        y = torch_asm.propagate(field, d, **KW, backend=backend)
        loss = (y.abs() ** 2 * torch.tensor(w[0])[:, None]).sum()
        grads[backend] = torch.autograd.grad(loss, (amp, d))
    checked = zip(grads["cuda"], grads["torch"]) if precision == "highest" else [
        (grads["cuda"][0], grads["torch"][0])]
    for g, r in checked:
        assert float((g - r).abs().max()) <= 1e-3 * float(r.abs().max())
        assert float(r.abs().max()) > 0


def _graph_names(t):
    names, todo = set(), [t.grad_fn]
    while todo:
        node = todo.pop()
        if node is not None and type(node).__name__ not in names:
            names.add(type(node).__name__)
            todo += [n for n, _ in node.next_functions]
    return names


@pytest.mark.parametrize("distance", [4e-4, "tensor"])
def test_propagate_cuda_goes_through_the_functions(distance):
    xre, xim, _ = _planes()
    d = torch.full((2, 1, 1), 4e-4) if distance == "tensor" else distance
    field = torch.complex(torch.tensor(xre), torch.tensor(xim)).requires_grad_()
    with torch.no_grad():
        assert asm_cuda.propagate_cuda(field, d, **KW).grad_fn is None
    op = "asm_dynamic" if distance == "tensor" else "asm_const"
    name = f"GeneratedBackwardFor_holostyle_{op}_defaultBackward"
    assert name in _graph_names(asm_cuda.propagate_cuda(field, d, **KW))


# --------------------------------------------------------------------------
# (b) tv_loss
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 1, 24, 20), (1, 1, 128, 128), (2, 3, 9, 31), (5, 16, 16)])
def test_tv_loss_matches_jax(shape):
    img = np.random.default_rng(len(shape) + shape[-1]).standard_normal(shape).astype(np.float32)
    got = float(tv_loss(torch.tensor(img)))
    ref = float(j_tv_loss(jnp.asarray(img)))
    assert got == pytest.approx(ref, rel=1e-6)


# --------------------------------------------------------------------------
# (c) physics_refine on golden batch 10 from a noisy GT phase
# --------------------------------------------------------------------------


def _psnr(ph, gt):
    return float(tmetrics.psnr(tmetrics.zero_mean(torch.tensor(np.asarray(ph))),
                               tmetrics.zero_mean(torch.tensor(gt))))


@pytest.fixture(scope="module")
def noisy_batch():
    g = load_golden_suite()
    gt = g.gt_phase[10]
    rng = np.random.default_rng(0)
    ph0 = (gt + 0.3 * rng.standard_normal(gt.shape)).astype(np.float32)
    amp = np.full_like(gt, CFG.data.amplitude)
    return amp, ph0, g.distance_content[10], np.sqrt(g.content_holo[10]), gt


@pytest.mark.parametrize("refine_distance", [False, True])
@pytest.mark.parametrize("steps", [10, 100])
def test_physics_refine_matches_jax_on_a_noisy_golden_batch(noisy_batch, steps, refine_distance):
    amp, ph0, d, meas, gt = noisy_batch
    kw = dict(steps=steps, optimize_amp=False, refine_distance=refine_distance)
    got = physics_refine(amp, ph0, d, meas, CFG.physics, device="cpu", **kw)
    ref = {k: np.asarray(v) for k, v in j_refine(amp, ph0, d, meas, JCFG.physics, **kw).items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in ref.items()}
    assert abs(_psnr(got["phase"], gt) - _psnr(ref["phase"], gt)) < 0.05
    assert np.abs(got["residual"] - ref["residual"]).max() < 1e-3
    err = np.abs(got["phase"] - ref["phase"])
    assert err.mean() < 1e-3
    # Pixel by pixel the 1e-3 holds for 99 % of the pixels at 10 steps (the
    # 99th percentile reads 1.2e-5, and 7.4e-4 with refine_distance), not
    # at 100 (2.4e-3 and 4.3e-3): that miss is logged in ROADMAP C.
    assert np.percentile(err, 99) < (1e-3 if steps == 10 else 1e-2)
    assert np.abs(got["distance"] - ref["distance"]).max() < 1e-3
    np.testing.assert_array_equal(got["amp"], amp)  # optimize_amp=False
    if steps == 100 and not refine_distance:
        assert _psnr(got["phase"], gt) > 38.8  # the JAX package: 38.925 dB


@pytest.mark.parametrize("refine_distance", [False, True])
def test_physics_refine_through_the_functions_matches_the_torch_backend(noisy_batch, refine_distance):
    """``asm_backend='cuda'`` on CPU tensors runs every step through
    the ``asm_dynamic`` op (the plain ``high`` forward, the adjoint backward): its
    refined PSNR is the ``torch`` backend's within 0.05 dB, the budget the
    card is held to against the CPU."""
    amp, ph0, d, meas, gt = noisy_batch
    kw = dict(steps=10, optimize_amp=False, refine_distance=refine_distance, device="cpu")
    got = physics_refine(amp, ph0, d, meas, CFG.physics, asm_backend="cuda", **kw)
    ref = physics_refine(amp, ph0, d, meas, CFG.physics, asm_backend="torch", **kw)
    assert abs(_psnr(got["phase"].numpy(), gt) - _psnr(ref["phase"].numpy(), gt)) < 0.05
    np.testing.assert_allclose(got["distance"].numpy(), ref["distance"].numpy(), atol=1e-3)
    with pytest.raises(ValueError):
        physics_refine(amp, ph0, d, meas, CFG.physics, asm_backend="xla", **kw)


def test_physics_refine_reduces_the_residual_with_the_amplitude_free(noisy_batch):
    amp, ph0, d, meas, _ = noisy_batch
    out = physics_refine(amp * 1.05, ph0, d, meas, CFG.physics, steps=10, device="cpu")
    start = torch.sqrt(holo_forward(torch.tensor(amp * 1.05), torch.tensor(ph0),
                                    torch.tensor(d), CFG.physics)) - torch.tensor(meas)
    r0 = torch.sqrt((start ** 2).mean(dim=(1, 2, 3)))
    assert bool((out["residual"] < r0).all())
    assert not np.array_equal(out["amp"].numpy(), amp * 1.05)
