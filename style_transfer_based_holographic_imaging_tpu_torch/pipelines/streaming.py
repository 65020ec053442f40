"""Streaming reconstruction, the red-blood-cell mode (port of the JAX
package's ``pipelines/streaming.py``).

A prefetched host -> card input stream (``data.prefetch``) feeds one
retrieval fn and yields the reconstructed fields batch by batch, with
throughput accounting. With a ``sharding`` (``parallel.batch_sharding`` of a
mesh) each batch is split over the mesh's ``data`` axis, each chunk
retrieved on its position's device by a replica of the net there, and the
chunks joined on the first device (batch data parallelism with one
controller, as the JAX package streams over a mesh).
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from style_transfer_based_holographic_imaging_tpu_torch.config import ExperimentConfig
from style_transfer_based_holographic_imaging_tpu_torch.data.prefetch import (
    data_devices,
    prefetch_to_device,
)
from style_transfer_based_holographic_imaging_tpu_torch.models.net import StyleTransferNet
from style_transfer_based_holographic_imaging_tpu_torch.pipelines.field_retrieval import (
    retrieval_replicas,
)
from style_transfer_based_holographic_imaging_tpu_torch.pipelines.refine import refine_retrieval

__all__ = ["stream_retrieval", "StreamStats"]


class StreamStats:
    """Frames yielded by a stream and the host time since it was made."""

    def __init__(self):
        self.n_frames = 0
        self.t_start = time.perf_counter()

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.t_start

    @property
    def frames_per_sec(self) -> float:
        return self.n_frames / max(self.elapsed, 1e-9)


def stream_retrieval(
    net: StyleTransferNet,
    batches: Iterable[Dict[str, np.ndarray]],
    style_vector: Tuple[np.ndarray, np.ndarray],
    config: Optional[ExperimentConfig] = None,
    *,
    style_distance: Optional[float] = None,
    dtype: Optional[torch.dtype] = None,
    stats: Optional[StreamStats] = None,
    refine_steps: int = 0,
    quant_scales: Optional[Dict[str, float]] = None,
    device: str | torch.device = "cuda",
    sharding=None,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Stream batches of intensity holograms through field retrieval.

    Each input batch is a dict with ``holo`` ``(B, 1, H, W)``; batches are
    prefetched to ``device`` (where ``net`` must lie) while the previous one
    computes. Yields the retrieval outputs, fp32 tensors on ``device``, per
    chunk: every batch is padded up or chunked down to the FIRST batch's
    size, so the net sees one shape, and the outputs are trimmed back; a
    batch larger than the first yields several dicts.

    ``style_distance`` is the style plane in millimetres (the config's first
    style distance when None). ``dtype`` is the fp net's compute dtype (fp32
    when None); ``quant_scales`` serves the int8 path in ``dtype`` (bf16 when
    None). ``refine_steps > 0`` refines each chunk's
    refocused field against its frames (amplitude and phase jointly: the
    experimental domains have no known-amplitude prior).

    ``sharding`` splits each batch over a mesh's ``data`` axis (the module
    docstring; ``device`` is then the first chunk's device, where the
    outputs are joined); the first batch's size must divide by the axis.
    """
    config = config or ExperimentConfig()
    devices = [torch.device(device)] if sharding is None else data_devices(sharding)
    replicas = retrieval_replicas(net, style_vector, config.physics, devices, alpha=config.eval.alpha,
                                  dtype=dtype, quant_scales=quant_scales)
    # The style distance in millimetres -> network units, a host float: the
    # refocus takes the constant-distance kernel.
    d_s_mm = config.data.style_distances[0] if style_distance is None else style_distance
    d_s = float(config.physics.to_network_units(d_s_mm))

    # Every batch to the FIRST batch's size, on the host: smaller ones (the
    # ragged tail) padded with their last frame, larger ones chunked.
    valid_counts: list[int] = []

    def padded(src):
        first_b = None
        for batch in src:
            b = next(iter(batch.values())).shape[0]
            if first_b is None:
                first_b = b
                if first_b % len(devices):
                    raise ValueError(f"batch size {first_b} must divide by the {len(devices)} "
                                     f"devices of the 'data' mesh axis")
            for lo in range(0, b, first_b):
                chunk = {k: np.asarray(v[lo : lo + first_b]) for k, v in batch.items()}
                cb = next(iter(chunk.values())).shape[0]
                if cb < first_b:
                    pad = first_b - cb
                    chunk = {
                        k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)], axis=0)
                        for k, v in chunk.items()
                    }
                valid_counts.append(cb)
                yield chunk

    for parts in prefetch_to_device(padded(batches), device=devices[0], sharding=sharding):
        parts = [parts] if sharding is None else parts
        outs = []
        for dev, part in zip(devices, parts):
            net_d, sm, ss, fn = replicas[dev]
            out = fn(net_d, part["holo"], sm, ss, d_s)
            if refine_steps:
                out = refine_retrieval(out, part["holo"], config.physics, steps=refine_steps,
                                       device=dev)
            outs.append(out)
        out = outs[0] if len(outs) == 1 else {
            k: torch.cat([o[k].to(devices[0]) for o in outs]) for k in outs[0]}
        b_valid = valid_counts.pop(0)
        if b_valid < sum(part["holo"].shape[0] for part in parts):
            out = {k: v[:b_valid] for k, v in out.items()}
        if stats is not None:
            stats.n_frames += b_valid
        yield out
