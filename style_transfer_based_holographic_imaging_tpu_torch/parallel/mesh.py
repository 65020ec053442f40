"""Device mesh, sharding specs and the process world (port of the JAX
package's ``parallel/mesh.py``).

The JAX package shards one program over a device mesh and lets GSPMD insert
the collectives. Here every collective is explicit and each mesh position is
a process of a ``torch.distributed`` world:

* ``Mesh`` holds the axis names, the shape and one ``torch.device`` for each
  position; position ``r`` (row-major over the axes) is rank ``r``.
* ``NamedSharding(mesh, spec)`` names, for each dim of a tensor, the mesh
  axis it is split over (``None``: whole); ``replicated`` and
  ``batch_sharding`` are the two the pipelines use, ``local`` cuts one
  position's shard out of a whole tensor.
* ``shard_batch`` splits a batch over the ``data`` axis into one chunk per
  position, on its device; ``local_rows`` says which rows of the global
  batch a position holds.
* ``launch`` spawns one process per position (``torch.multiprocessing``
  with ``spawn``), joins them to one world and runs a function in each:
  ``nccl`` where every rank has a card of its own, ``gloo`` on the CPU and
  where ranks share a card. The rendezvous is a ``FileStore`` in a new
  temporary directory, so worlds started at once never meet. ``init_world``
  does the same for the calling process alone (a 1-rank world).
* ``Mesh.groups()`` makes one process group per axis (the ranks that differ
  only along it); ``all_reduce``, ``all_gather`` and ``reduce_scatter`` run
  over one of them along one dim of a tensor.

Single-device work needs no mesh: entry points take ``mesh=None`` for it.
"""

from __future__ import annotations

import datetime
import math
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "DATA_AXIS",
    "FFT_AXIS",
    "Mesh",
    "NamedSharding",
    "make_mesh",
    "replicated",
    "batch_sharding",
    "shard_batch",
    "local_rows",
    "tree_map_with_path",
    "default_backend",
    "COLLECTIVE_TIMEOUT_S",
    "init_world",
    "close_world",
    "launch",
    "all_reduce",
    "all_gather",
    "reduce_scatter",
]

DATA_AXIS = "data"
FFT_AXIS = "fft"

# torch 2.13 renames the tensor forms of the two collectives; older releases
# (the card machine's 2.11) have only the first names.
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


class Mesh:
    """Devices on a grid of named axes. ``devices`` is an object array of
    ``torch.device`` of the mesh's shape; ``shape`` maps each axis name to
    its size, in order, as the JAX ``Mesh.shape`` does."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-D device array for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names, devices.shape))
        self._groups: Optional[Dict[str, Any]] = None
        self._world = None

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_list(self) -> List[torch.device]:
        return list(self.devices.reshape(-1))

    def coords(self, rank: int) -> Dict[str, int]:
        """Position ``rank``'s index along each axis."""
        idx = np.unravel_index(rank, self.devices.shape)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def axis_ranks(self, axis: str, rank: int) -> List[int]:
        """The ranks that differ from ``rank`` only along ``axis``, in order."""
        c = self.coords(rank)
        k = self.axis_names.index(axis)
        idx = [c[a] for a in self.axis_names]
        out = []
        for i in range(self.devices.shape[k]):
            idx[k] = i
            out.append(int(np.ravel_multi_index(idx, self.devices.shape)))
        return out

    def groups(self) -> Dict[str, Any]:
        """This rank's process group along each axis, made on the first call.
        Every rank of the world must make that call at the same point: each
        group is made by all of them (``dist.new_group``), in one order."""
        if self._groups is None or self._world is not dist.group.WORLD:
            if not dist.is_initialized() or dist.get_world_size() != self.size:
                raise RuntimeError(
                    f"a {self.size}-position mesh needs a world of {self.size} ranks "
                    f"(parallel.launch or parallel.init_world)")
            rank = dist.get_rank()
            groups = {}
            for axis in self.axis_names:
                seen = set()
                for r in range(self.size):
                    members = tuple(self.axis_ranks(axis, r))
                    if members in seen:
                        continue
                    seen.add(members)
                    g = dist.new_group(list(members))
                    if rank in members:
                        groups[axis] = g
            self._groups, self._world = groups, dist.group.WORLD
        return self._groups

    def __getstate__(self):
        return {"devices": self.devices, "axis_names": self.axis_names}

    def __setstate__(self, d):
        self.__init__(d["devices"], d["axis_names"])

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and self.axis_names == other.axis_names
                and self.devices.shape == other.devices.shape
                and self.device_list == other.device_list)

    def __repr__(self) -> str:
        shape = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({shape}; {', '.join(map(str, self.device_list))})"


def make_mesh(
    n_devices: Optional[int] = None,
    *,
    axis_names: Sequence[str] = (DATA_AXIS,),
    shape: Optional[Sequence[int]] = None,
    devices: Optional[Sequence[torch.device | str]] = None,
) -> Mesh:
    """A mesh over the first ``n_devices`` devices (default: all): the
    cards ``cuda:0 .. cuda:k-1``, or ``devices`` when given. A device may
    appear more than once (two positions sharing one card, or the CPU).

    ``shape`` splits the devices over several axes, e.g.
    ``make_mesh(4, axis_names=('data', 'model'), shape=(2, 2))``.
    """
    if devices is None:
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested a {n_devices}-device mesh but only {len(devs)} devices are available")
        devs = devs[:n_devices]
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("shape required for multi-axis meshes")
        shape = (len(devs),)
    n_mesh = int(np.prod(tuple(shape)))
    if n_mesh > len(devs):
        raise ValueError(
            f"mesh shape {tuple(shape)} needs {n_mesh} devices but only {len(devs)} are available")
    # A shape given without n_devices uses the first prod(shape) devices.
    arr = np.empty(n_mesh, dtype=object)
    arr[:] = devs[:n_mesh]
    return Mesh(arr.reshape(tuple(shape)), axis_names)


class NamedSharding:
    """A layout of a tensor on ``mesh``: ``spec[i]`` is the axis that dim
    ``i`` is split over in equal chunks, or ``None`` (trailing dims whole).
    Position ``r`` holds chunk ``coords(r)[axis]`` of each split dim. A leaf
    of ``tree_map_with_path``, as a tensor is."""

    def __init__(self, mesh: Mesh, spec: tuple = ()):
        self.mesh = mesh
        self.spec = tuple(spec)

    def __eq__(self, other) -> bool:
        return isinstance(other, NamedSharding) and (self.mesh, self.spec) == (other.mesh, other.spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec})"

    @property
    def is_fully_replicated(self) -> bool:
        return all(a is None for a in self.spec)

    def split_dims(self) -> Dict[str, int]:
        """{axis: the dim split over it}."""
        return {a: i for i, a in enumerate(self.spec) if a is not None}

    def shard_shape(self, shape: Sequence[int]) -> tuple:
        out = list(shape)
        for i, a in enumerate(self.spec):
            if a is not None:
                out[i] //= self.mesh.shape[a]
        return tuple(out)

    def local(self, x: torch.Tensor, rank: int) -> torch.Tensor:
        """Position ``rank``'s shard of the whole tensor ``x`` (a view)."""
        c = self.mesh.coords(rank)
        for i, a in enumerate(self.spec):
            if a is not None:
                n = x.shape[i] // self.mesh.shape[a]
                x = x.narrow(i, c[a] * n, n)
        return x


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def batch_sharding(mesh: Mesh, axis: str = DATA_AXIS, ndim: int = 4) -> NamedSharding:
    """Split the leading (batch) dim over ``axis``, the rest whole."""
    return NamedSharding(mesh, (axis,) + (None,) * (ndim - 1))


def local_rows(batch_size: int, mesh: Mesh, rank: int, axis: str = DATA_AXIS,
               micro_batches: int = 1) -> np.ndarray:
    """The rows of a global batch of ``batch_size`` that position ``rank``
    holds: with ``micro_batches`` k, the batch is first cut into k equal
    micro-batches (the one-process step's ``grad_accum``) and each of them
    split over ``axis``, so that the rank's micro-batch i is its share of the
    one-process micro-batch i. k = 1 is the contiguous block of
    ``shard_batch``."""
    n = mesh.shape[axis]
    if batch_size % (n * micro_batches):
        raise ValueError(
            f"batch_size {batch_size} must be divisible by the '{axis}' mesh axis size ({n})"
            + (f" times grad_accum={micro_batches}" if micro_batches > 1 else ""))
    d = mesh.coords(rank)[axis]
    per_micro = batch_size // micro_batches
    chunk = per_micro // n
    return np.concatenate([np.arange(i * per_micro + d * chunk, i * per_micro + (d + 1) * chunk)
                           for i in range(micro_batches)])


def tree_map_with_path(fn: Callable, tree, *rest, path: tuple = ()):
    """``fn(path, leaf, *rest_leaves)`` over a tree of dataclasses, dicts and
    leaves (anything else; ``None`` stays ``None``), rebuilt in its type. The
    path holds field names and dict keys."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *[r[k] for r in rest], path=path + (k,))
                for k, v in tree.items()}
    if hasattr(tree, "__dataclass_fields__"):
        return type(tree)(**{
            f: tree_map_with_path(fn, getattr(tree, f), *[getattr(r, f) for r in rest],
                                  path=path + (f,))
            for f in tree.__dataclass_fields__})
    return fn(path, tree, *rest)


def shard_batch(batch, mesh: Mesh, axis: str = DATA_AXIS) -> List[Any]:
    """A tree of batch-major arrays split over ``axis``: one tree a mesh
    position, in rank order, each on its position's device. Scalar leaves
    (loss weights, flags) are copied whole to every position."""
    out = []
    for r, dev in enumerate(mesh.device_list):

        def put(_, x, r=r, dev=dev):
            t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
            if t.ndim == 0:
                return t.to(dev)
            return batch_sharding(mesh, axis, t.ndim).local(t, r).to(dev)

        out.append(tree_map_with_path(put, batch))
    return out


# --------------------------------------------------------------------------
# The world: one process per mesh position
# --------------------------------------------------------------------------


def default_backend(mesh: Mesh) -> str:
    """``nccl`` when every position has a card of its own, else ``gloo``
    (the CPU, or positions sharing a card: NCCL refuses two ranks on one
    device)."""
    devs = mesh.device_list
    if all(d.type == "cuda" for d in devs) and len({d.index for d in devs}) == len(devs):
        return "nccl"
    return "gloo"


def _cpu_threads(mesh: Mesh) -> int:
    """Torch threads of a CPU rank: the cores shared out, at least one."""
    return max(1, (os.cpu_count() or 1) // (2 * mesh.size))


#: The kernel sources a rank's train step can launch (the synthesis's ASM
#: kernels, the border ring): rank 0 builds them before the world's first
#: launch.
WORLD_KERNELS = ("asm_propagate", "reflect_border")


#: Seconds a collective waits for the other ranks before it fails.
COLLECTIVE_TIMEOUT_S = 600.0


def init_world(mesh: Mesh, rank: int, *, store_path: Optional[str] = None,
               timeout: float = COLLECTIVE_TIMEOUT_S, threads: Optional[int] = None) -> None:
    """Join this process to the world of ``mesh`` as ``rank``: the process
    group (``default_backend``; every collective times out after
    ``timeout`` seconds), the rank's card as the current device, on the CPU
    ``threads`` torch threads, and the mesh's groups.
    ``store_path`` is the ``FileStore`` file all ranks share (a new one in a
    temporary directory when None, which only a 1-rank world can use).

    On the card rank 0 builds ``WORLD_KERNELS`` (where the build directory
    lacks them) while the others wait at a barrier: N ranks starting at once
    would otherwise each run ``nvcc`` on the same sources. No rank removes
    another's partial build files (``_build.remove_stale``)."""
    dev = mesh.device_list[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(threads or _cpu_threads(mesh))
    if store_path is None:
        if mesh.size != 1:
            raise ValueError("a world of several ranks needs one store_path for all of them")
        store_path = os.path.join(tempfile.mkdtemp(prefix="holostyle_world_"), "store")
    store = dist.FileStore(store_path, mesh.size)
    dist.init_process_group(default_backend(mesh), store=store, rank=rank,
                            world_size=mesh.size, timeout=datetime.timedelta(seconds=timeout))
    mesh.groups()
    if dev.type == "cuda":
        if rank == 0:
            from style_transfer_based_holographic_imaging_tpu_torch.kernels import _build

            _build.build(*WORLD_KERNELS)
        dist.barrier()


def close_world() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _to_host(tree):
    """Tensors of a result to the CPU, so that it pickles by value."""
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if hasattr(tree, "__dataclass_fields__"):
        return type(tree)(**{f: _to_host(getattr(tree, f)) for f in tree.__dataclass_fields__})
    return tree


def _rank_main(fn, mesh, rank, store_path, timeout, threads, args, results):
    try:
        init_world(mesh, rank, store_path=store_path, timeout=timeout, threads=threads)
        out = fn(rank, *args)
        results.put((rank, True, pickle.dumps(_to_host(out))))
    except BaseException:  # noqa: BLE001 — reported to the parent, which fails the launch
        results.put((rank, False, traceback.format_exc()))
    finally:
        close_world()


def launch(fn: Callable, mesh: Mesh, *args, timeout: Optional[float] = 600.0,
           threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(rank, *args)`` in one new process a mesh position, joined to
    the mesh's world (``init_world``), and return each rank's result, in rank
    order (tensors moved to the CPU). ``fn`` and ``args`` must pickle:
    ``fn`` a function of a module the processes can import.

    The whole launch has ``timeout`` seconds, each collective too; with
    ``timeout=None`` the run has no deadline (a training run of any length)
    and each collective COLLECTIVE_TIMEOUT_S. A rank that raises, dies or
    outlives the deadline fails the launch (RuntimeError, or TimeoutError),
    and every rank still running is killed. Nothing is left running when
    this returns or raises."""
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="holostyle_world_")
    store_path = os.path.join(tmp, "store")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, mesh, r, store_path,
                               COLLECTIVE_TIMEOUT_S if timeout is None else timeout, threads, args,
                               results))
             for r in range(mesh.size)]
    deadline = math.inf if timeout is None else time.monotonic() + timeout
    got: Dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        while len(got) < mesh.size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"{mesh.size}-rank world: ranks {sorted(set(range(mesh.size)) - set(got))} "
                    f"did not finish within {timeout:.0f} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and not p.is_alive() and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} of the {mesh.size}-rank world died "
                                       f"with exit code {procs[dead[0]].exitcode}") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of the {mesh.size}-rank world failed:\n{payload}")
            got[rank] = pickle.loads(payload)
        for p in procs:
            p.join(min(max(deadline - time.monotonic(), 1.0), COLLECTIVE_TIMEOUT_S))
        return [got[r] for r in range(mesh.size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------
# Collectives along one dim
# --------------------------------------------------------------------------


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, in place."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's shards of one tensor, ``x`` this rank's, joined along
    ``dim`` in rank order."""
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=x.dtype, device=x.device)
    _ALL_GATHER(out, src, group=group)
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the sum of ``x`` over ``group``."""
    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]), dtype=x.dtype, device=x.device)
    _REDUCE_SCATTER(out, src, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim)
