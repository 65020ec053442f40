"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and the CUDA toolkit (the kernels are compiled
with ``nvcc`` at first use); elsewhere they skip. On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Tolerance on max|err| / max|plain|: the JAX package's budgets per precision
mode (1e-5 highest, 1e-4 high, 2e-2 bf16); kernel and plain version round
alike and differ only in the order of their fp32 sums.
"""

import pytest
import torch

from style_transfer_based_holographic_imaging_tpu_torch.kernels import asm_cuda
from style_transfer_based_holographic_imaging_tpu_torch.ops import asm as torch_asm

pytestmark = pytest.mark.cuda

KW = dict(wavelength=532e-9, pixel_size=1.5e-6)
BUDGETS = {"highest": 1e-5, "high": 1e-4, "bf16": 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _planes(b, h, w, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(b, h, w, generator=g).to(device), torch.rand(b, h, w, generator=g).to(device))


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("precision", ["highest", "high", "bf16"])
@pytest.mark.parametrize("shape", [(3, 128, 128), (2, 48, 64), (1, 16, 16)])
def test_kernels_match_plain_versions(card, precision, shape):
    b, h, w = shape
    xre, xim = _planes(b, h, w, card)
    dist = torch.linspace(-8e-4, 8e-4, b, device=card)
    for run, plain in (
        (asm_cuda.asm_const, asm_cuda.asm_const_plain),
        (asm_cuda.asm_dynamic, asm_cuda.asm_dynamic_plain),
    ):
        d = -2e-4 if run is asm_cuda.asm_const else dist
        y = torch.complex(*run(xre, xim, d, precision=precision, **KW))
        p = torch.complex(*plain(xre, xim, d, precision=precision, **KW))
        torch.cuda.synchronize()
        assert _rel(y, p) < BUDGETS[precision]


def test_propagate_auto_takes_the_kernels_on_the_card(card):
    xre, xim = _planes(4, 128, 128, card)
    field = torch.complex(xre, xim)[:, None]
    asm_cuda.reset_launches()
    const = torch_asm.propagate(field, -2e-4, **KW)
    dyn = torch_asm.propagate(field, torch.full((4, 1, 1, 1), -2e-4, device=card), **KW)
    assert asm_cuda.LAUNCHES == {"asm_const": 1, "asm_dynamic": 1}
    exact = torch_asm.propagate_torch(field, -2e-4, **KW)
    assert _rel(const, exact) < BUDGETS["high"]
    assert _rel(dyn, const) < 1e-5


def test_wrapper_rejects_tensors_on_two_devices(card):
    xre, xim = _planes(2, 32, 32, card)
    with pytest.raises(ValueError):
        asm_cuda.asm_const(xre, xim.cpu(), -2e-4, **KW)
    with pytest.raises(ValueError):
        asm_cuda.asm_dynamic(xre, xim, torch.zeros(2), **KW)
