"""Host -> card prefetch (port of the JAX package's ``data/prefetch.py``).

A producer thread reads the batches, copies each array into pinned host
memory and starts its copy to the card with ``non_blocking=True`` on a side
CUDA stream, so the next batches cross while the consumer computes (a
bounded queue: double or treble buffering). The consumer's stream waits on
each batch's copy event before it uses the batch, and the batch's card
memory is recorded on the consumer's stream, so the allocator does not hand
it to the next copy while the consumer's kernels still read it.

On ``device="cpu"`` the batches pass through in order, their numpy arrays
as CPU tensors (no copy).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterable, Iterator

import numpy as np
import torch

__all__ = ["prefetch_to_device"]

_SENTINEL = object()


def _map(fn: Callable, batch: Dict[str, Any]) -> Dict[str, Any]:
    return {k: fn(v) for k, v in batch.items()}


def _as_tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))


def prefetch_to_device(
    batches: Iterable[Dict[str, Any]],
    *,
    buffer_size: int = 2,
    device: str | torch.device = "cuda",
) -> Iterator[Dict[str, torch.Tensor]]:
    """Iterate ``batches`` (dicts of numpy arrays or CPU tensors), each staged
    onto ``device`` ahead of its use. A batch yielded on a card is ready for
    work queued on the current stream."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in batches:
            yield _map(_as_tensor, batch)
        return

    side = torch.cuda.Stream(device)
    q: "queue.Queue[Any]" = queue.Queue(maxsize=buffer_size)
    err: list[BaseException] = []
    stop = threading.Event()

    def put(batch):
        """(the batch on the card, its copy's event, the pinned buffers)."""
        pinned = _map(lambda x: _as_tensor(x).pin_memory(), batch)
        with torch.cuda.stream(side):
            staged = _map(lambda t: t.to(device, non_blocking=True), pinned)
            done = torch.cuda.Event()
            done.record(side)
        return staged, done, pinned

    def q_put(item) -> bool:
        # Bounded put that gives up when the consumer abandoned the
        # iterator: a plain q.put() would block this thread forever and pin
        # the staged batches it holds.
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in batches:
                if not q_put(put(batch)):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised on the consumer side
            err.append(e)
        finally:
            q_put(_SENTINEL)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            staged, done, _pinned = item
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            _map(lambda x: x.record_stream(consumer), staged)
            # The pinned buffers may go now: a non-blocking copy records its
            # event with torch's pinned-memory allocator, which reuses no
            # block before that event.
            del item, _pinned
            yield staged
    finally:
        # Consumer exited (break / exception / GC): release the producer and
        # drop any staged batches so their buffers free promptly.
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
