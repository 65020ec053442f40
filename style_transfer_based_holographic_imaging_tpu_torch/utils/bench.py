"""Timing, seeded inputs and yardsticks for the port's measurement scripts
(``chip_smoke.py``, ``scripts/port_exp_halo_conv.py``,
``scripts/port_exp_head_ring.py``)."""

from __future__ import annotations

import contextlib
import statistics
import time

import torch
import torch.nn.functional as F

from style_transfer_based_holographic_imaging_tpu_torch.kernels import reflect_border

__all__ = ["median_ms", "seeded_stack", "head_library", "ring_inputs", "recording_ring_layers",
           "time_ring_layers"]


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


def seeded_stack(b: int, dtype, c_in: int, widths, seed: int, device, size=128):
    """Input and (kernel, bias) pairs of a 3x3 conv stack from
    ``device``'s ``torch.Generator`` seed ``seed`` (drawn on the device: an
    input at B = 256 is a quarter of a billion values): x ``(b, c_in, H,
    W)`` in [0, 1) with ``size`` H = W or an ``(H, W)`` pair, He-normal OIHW
    kernels (std sqrt(2 / fan_in)) in ``dtype``, N(0, 0.01^2) fp32 biases."""
    h, w = (size, size) if isinstance(size, int) else size
    g = torch.Generator(device=device).manual_seed(seed)
    args = [torch.rand(b, c_in, h, w, generator=g, device=device).to(dtype)]
    c = c_in
    for o in widths:
        k = torch.randn(o, c, 3, 3, generator=g, device=device) * (2.0 / (9 * c)) ** 0.5
        args += [k.to(dtype), 0.01 * torch.randn(o, generator=g, device=device)]
        c = o
    return args


def head_library(x, k1, b1, k2, b2):
    """The encoder head as cuDNN's convs in x's dtype (the timing
    yardstick): per layer a ReflectionPad2d(1), the conv with the bias, the
    relu; then the 2x2/2 max pool."""
    for k, b in ((k1, b1), (k2, b2)):
        x = F.relu(F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), k, b.to(x.dtype)))
    return F.max_pool2d(x, 2, 2)


def ring_inputs(b: int, layer, seed: int, device, dtype=torch.float32):
    """x ``(b, C, H, W)`` and k ``(O, C, 3, 3)`` of the border ring at one
    layer ``(C, H, W, O)``, drawn in fp32 on ``device`` from seed ``seed``
    (a deep layer's input is hundreds of MB at B = 256), then cast to
    ``dtype``: x standard normal, k He-normal."""
    c, h, w, o = layer
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(b, c, h, w, generator=g, device=device).to(dtype)
    k = (torch.randn(o, c, 3, 3, generator=g, device=device) * (2.0 / (9 * c)) ** 0.5).to(dtype)
    return x, k


@contextlib.contextmanager
def recording_ring_layers():
    """Within the block, every ``reflect_border.border_lines`` call (the
    reflect convs look it up at each call) appends its layer ``(C, H, W,
    O)`` to the list this yields, and then runs the ring."""
    seen = []
    ring = reflect_border.border_lines

    def recording(x, k):
        seen.append((x.shape[1], x.shape[2], x.shape[3], k.shape[0]))
        return ring(x, k)

    reflect_border.border_lines = recording
    try:
        yield seen
    finally:
        reflect_border.border_lines = ring


def time_ring_layers(layers, b: int, device, reps: int = 9, dtype=torch.float32,
                     plain: bool = False) -> dict:
    """The ring at each distinct layer ``(C, H, W, O)`` of ``layers`` at
    batch b, on ``ring_inputs`` of seed 3 in ``dtype``: by key
    ``"CxHxWxO"`` the layer, its CUDA-event median in ms (with ``plain``
    also ``plain_ms``, ``border_lines_plain``'s) and how many of ``layers``
    have that shape (``convs``)."""
    by_layer = {}
    for layer in layers:
        key = "x".join(map(str, layer))
        if key not in by_layer:
            x, k = ring_inputs(b, layer, 3, device, dtype)
            ms = median_ms(lambda: reflect_border.border_lines(x, k), reps=reps)
            by_layer[key] = {"layer": tuple(layer), "ms": ms, "convs": 0}
            if plain:
                by_layer[key]["plain_ms"] = median_ms(lambda: reflect_border.border_lines_plain(x, k),
                                                      reps=reps)
            del x, k
        by_layer[key]["convs"] += 1
    return by_layer
