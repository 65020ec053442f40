"""Timing and seeded inputs for the port's measurement scripts
(``chip_smoke.py``, ``scripts/port_exp_halo_conv.py``)."""

from __future__ import annotations

import statistics
import time

import torch

__all__ = ["median_ms", "seeded_stack"]


def median_ms(fn, reps: int = 15, warmup: int = 3, cuda: bool = True) -> float:
    """Median over ``reps`` calls of ``fn`` after ``warmup`` calls, in ms:
    CUDA-event time on the current card, or with ``cuda`` false the host
    clock."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def seeded_stack(b: int, dtype, c_in: int, widths, seed: int, device, size: int = 128):
    """Input and (kernel, bias) pairs of a 3x3 conv stack from
    ``torch.Generator`` seed ``seed``: x ``(b, c_in, size, size)`` in [0, 1),
    He-normal OIHW kernels (std sqrt(2 / fan_in)) in ``dtype``, N(0, 0.01^2)
    fp32 biases."""
    g = torch.Generator().manual_seed(seed)
    args = [torch.rand(b, c_in, size, size, generator=g).to(device, dtype)]
    c = c_in
    for o in widths:
        k = torch.randn(o, c, 3, 3, generator=g) * (2.0 / (9 * c)) ** 0.5
        args += [k.to(device, dtype), (0.01 * torch.randn(o, generator=g)).to(device)]
        c = o
    return args
