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

With ``sharding`` (``parallel.batch_sharding`` of a mesh) each batch is
split over the mesh's ``data`` axis and each chunk staged onto the device of
its ``data`` position (the first along the other axes), every device with
pinned buffers and a side stream of its own; each item is then the list of
the chunks, in order.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterable, Iterator, List

import numpy as np
import torch

__all__ = ["prefetch_to_device", "data_devices"]

_SENTINEL = object()


def _map(fn: Callable, batch: Dict[str, Any]) -> Dict[str, Any]:
    return {k: fn(v) for k, v in batch.items()}


def _as_tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))


def data_devices(sharding) -> List[torch.device]:
    """The device of each ``data`` position of a batch sharding's mesh: the
    first along the other axes."""
    mesh, axis = sharding.mesh, sharding.spec[0]
    lead = np.moveaxis(mesh.devices, mesh.axis_names.index(axis), 0)
    return [torch.device(d) for d in lead.reshape(mesh.shape[axis], -1)[:, 0]]


def prefetch_to_device(
    batches: Iterable[Dict[str, Any]],
    *,
    buffer_size: int = 2,
    device: str | torch.device = "cuda",
    sharding=None,
) -> Iterator[Any]:
    """Iterate ``batches`` (dicts of numpy arrays or CPU tensors), each staged
    onto ``device`` ahead of its use; with ``sharding``, each split into
    one chunk a ``data`` position, staged onto that position's device (the
    list of chunks; ``device`` is then not read). A batch yielded on a card
    is ready for work queued on the current stream."""
    devices = [torch.device(device)] if sharding is None else data_devices(sharding)

    def split(batch):
        if sharding is None:
            return [batch]
        n = len(devices)
        return [{k: v[i * (len(v) // n):(i + 1) * (len(v) // n)] for k, v in batch.items()}
                for i in range(n)]

    def out(parts):
        return parts[0] if sharding is None else parts

    if not any(d.type == "cuda" for d in devices):
        for batch in batches:
            yield out([_map(lambda x, d=d: _as_tensor(x).to(d), part)
                       for d, part in zip(devices, split(batch))])
        return

    sides = {d: torch.cuda.Stream(d) for d in devices if d.type == "cuda"}
    q: "queue.Queue[Any]" = queue.Queue(maxsize=buffer_size)
    err: list[BaseException] = []
    stop = threading.Event()

    def put_part(dev, part):
        """(the part on its device, its copy's event or None, the pinned buffers)."""
        if dev.type != "cuda":
            return _map(_as_tensor, part), None, None
        pinned = _map(lambda x: _as_tensor(x).pin_memory(), part)
        with torch.cuda.stream(sides[dev]):
            staged = _map(lambda t: t.to(dev, non_blocking=True), pinned)
            done = torch.cuda.Event()
            done.record(sides[dev])
        return staged, done, pinned

    def put(batch):
        return [put_part(d, part) for d, part in zip(devices, split(batch))]

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
            parts = []
            for dev, (staged, done, _pinned) in zip(devices, item):
                if done is not None:
                    consumer = torch.cuda.current_stream(dev)
                    consumer.wait_event(done)
                    _map(lambda x, c=consumer: x.record_stream(c), staged)
                parts.append(staged)
            # The pinned buffers may go now: a non-blocking copy records its
            # event with torch's pinned-memory allocator, which reuses no
            # block before that event.
            del item, _pinned
            yield out(parts)
    finally:
        # Consumer exited (break / exception / GC): release the producer and
        # drop any staged batches so their buffers free promptly.
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
