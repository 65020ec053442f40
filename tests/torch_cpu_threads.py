"""Shared by the port's serving tests: torch's CPU thread pool, warmed.

On some hosts (an 8-core x86 VM, torch 2.13 for the CPU), the first
multi-threaded elementwise op that follows a large ``normal_`` and
``copy_`` (building a net and loading its state dict does both) returns one
worker's chunk with about 2**-12 relative error, in some of the processes;
every later op agrees with numpy to an ulp, and one thread never shows
it. torch and numpy alone reproduce it (PERF.md section 6), so it is no
fault of the port; but these files hold the port to the JAX package and to
itself at 1e-4 of max and bit for bit, so such a chunk would fail them.

``warm_torch_threads`` (autouse, once per module that imports it) runs
that sequence until two rounds in a row agree with numpy, then leaves
torch's thread count as it found it: the comparisons run multi-threaded,
the port's handler threads and prefetch included.
``warm_few_torch_threads`` does the same at fewer threads.
"""

import numpy as np
import pytest
import torch

_N = 1 << 20
_ROUNDS = 20


def warm_thread_pool() -> int:
    """Run normal_ -> copy_ -> sqrt until two rounds in a row agree with
    numpy's sqrt; returns the rounds that did not (raises if the pool
    never settles)."""
    bad, clean = 0, 0
    g = torch.Generator().manual_seed(0)
    for _ in range(_ROUNDS):
        src = torch.empty(_N).normal_(generator=g).abs_()
        x = torch.empty_like(src).copy_(src)
        # torch's and numpy's sqrt differ by an ulp here and there: 1e-6.
        if torch.allclose(torch.sqrt(x), torch.from_numpy(np.sqrt(x.numpy())), rtol=1e-6, atol=0):
            clean += 1
            if clean == 2:
                return bad
        else:
            bad, clean = bad + 1, 0
    raise RuntimeError(f"torch's sqrt disagreed with numpy's in {bad} of {_ROUNDS} rounds")


@pytest.fixture(autouse=True, scope="module")
def warm_torch_threads():
    warm_thread_pool()
    yield


#: torch's CPU threads in a module that uses ``warm_few_torch_threads``.
FEW_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def warm_few_torch_threads():
    """``warm_torch_threads`` at FEW_THREADS threads, the count restored
    after the module. The suite runs in parallel workers on a host with as
    many cores as torch takes threads by default, and a small model's ops
    then wait on threads that other workers hold: at two threads such a
    test takes a fraction of its time under that load."""
    n = torch.get_num_threads()
    torch.set_num_threads(FEW_THREADS)
    warm_thread_pool()
    yield
    torch.set_num_threads(n)
