"""ZeRO-style sharded training state over the ``data`` axis (port of the
JAX package's ``parallel/zero.py``), and the named partition plans.

A plan is a ``TrainState``-shaped tree of ``NamedSharding``: for each leaf,
the dim of the port's tensor that is split over a mesh axis. The train step
(``train/loop.py``) reads it and runs the collectives the JAX package leaves
to GSPMD:

* **ZeRO-1** (``zero1``): the Adam moments (the discriminator's too) are
  split over ``data``, the params and EMA stay whole. The gradients are
  reduce-scattered into the moment's shard, Adam updates that shard of the
  params, and one all-gather over ``data`` rebuilds them.
* **FSDP** (``fsdp``): the params and EMA are split as well; the step
  all-gathers the whole net at its start and reduce-scatters the
  gradients, and each rank updates its shard in place.

The sharding rule (``zero_leaf_spec``) is the JAX package's, on the logical
dims: a dense kernel splits its output dim, every other leaf its first dim
in the JAX layout's order that divides by the axis (for a conv's HWIO
kernel that is the input channels, not the output channels that ``tp``
takes, so the two compose on a 2-D mesh). The port's tensors lie otherwise
(OIHW convs, ``(O, I)`` dense), so the rule walks the JAX dims and names
the port dim each one is (``jax_dims``). Indivisible leaves stay whole.

``shard_state`` cuts one rank's state out of a whole one; ``gather_state``
(a collective) puts the whole state back together on every rank, for a
snapshot or the end of a run, so a snapshot is the same file whatever the
partition, and restores into any other.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from style_transfer_based_holographic_imaging_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    NamedSharding,
    all_gather,
    replicated,
    tree_map_with_path,
)

__all__ = [
    "jax_dims",
    "zero_leaf_spec",
    "zero_state_shardings",
    "merge_state_shardings",
    "partition_state_shardings",
    "PARTITION_PLANS",
    "shard_state",
    "gather_state",
]

_OPT_GROUPS = ("opt_state", "disc_opt_state")


def jax_dims(name: str, ndim: int) -> Tuple[int, ...]:
    """The port dims of a parameter ``name`` (state-dict key) in the order of
    the JAX package's dims: a conv kernel is HWIO there and OIHW here, a
    dense kernel ``(I, O)`` there and ``(O, I)`` here; the transposed convs
    (``up*``, ``(C_in, C_out, 2, 2)`` in both) and biases lie alike."""
    layer = name.split(".")[-2] if "." in name else ""
    if ndim == 4 and not layer.startswith("up"):
        return (2, 3, 1, 0)
    if ndim == 2:
        return (1, 0)
    return tuple(range(ndim))


def zero_leaf_spec(name: str, leaf: Any, axis_size: int, axis: str) -> tuple:
    """The spec splitting one dim of ``leaf`` over ``axis``: a dense kernel's
    output dim, else the first dim (in the JAX layout's order) that divides
    by ``axis_size``; ``()`` (whole) when none does."""
    shape = tuple(getattr(leaf, "shape", ()))
    port = jax_dims(name, len(shape))
    order = (1, 0) if len(shape) == 2 else range(len(shape))
    for j in order:
        i = port[j]
        if shape[i] % axis_size == 0 and shape[i] >= axis_size:
            spec = [None] * len(shape)
            spec[i] = axis
            return tuple(spec)
    return ()


def zero_state_shardings(state, mesh: Mesh, axis: str = DATA_AXIS, *, shard_params: bool = False):
    """The plan of a ``train.state.TrainState``: ``shard_params=False`` is
    ZeRO-1 (the leaves under ``opt_state``/``disc_opt_state`` split, the rest
    whole), ``True`` FSDP (every divisible tensor split)."""
    n = mesh.shape[axis]
    repl = replicated(mesh)

    def one(path, leaf):
        if not torch.is_tensor(leaf):
            return repl
        if not shard_params and not any(k in _OPT_GROUPS for k in path):
            return repl
        return NamedSharding(mesh, zero_leaf_spec(path[-1], leaf, n, axis))

    return tree_map_with_path(one, state)


def merge_state_shardings(a, b):
    """Left-precedence leaf-wise merge of two plans on one mesh: every dim
    named in ``a`` keeps its axis; a dim unnamed in ``a`` takes ``b``'s axis
    unless that axis already splits another dim of the leaf (a bias both
    plans want dim 0 of keeps ``a``'s). ``tp_fsdp`` is
    ``merge(tp_state_shardings, zero_state_shardings(shard_params=True))``."""

    def merge(_, sa, sb):
        if not isinstance(sa, NamedSharding):
            return sa
        if sa.mesh != sb.mesh:
            raise ValueError("merge_state_shardings: shardings on different meshes")
        pa, pb = tuple(sa.spec), tuple(sb.spec)
        n = max(len(pa), len(pb))
        pa += (None,) * (n - len(pa))
        pb += (None,) * (n - len(pb))
        used = {x for x in pa if x is not None}
        out = []
        for da, db in zip(pa, pb):
            if da is None and db is not None and db not in used:
                used.add(db)
                out.append(db)
            else:
                out.append(da)
        return NamedSharding(sa.mesh, tuple(out) if any(x is not None for x in out) else ())

    return tree_map_with_path(merge, a, b)


#: The named plans (``cli train --partition``).
PARTITION_PLANS = ("dp", "zero1", "fsdp", "tp", "tp_fsdp")


def partition_state_shardings(partition: str, state, mesh: Mesh):
    """A named plan: ``dp`` -> ``None`` (everything whole, plain data
    parallelism); ``zero1``/``fsdp`` -> ``zero_state_shardings`` over
    ``data``; ``tp`` -> ``parallel.tp.tp_state_shardings`` over ``model``
    (the mesh must have that axis); ``tp_fsdp`` -> both, merged."""
    if partition == "dp":
        return None
    if partition == "zero1":
        return zero_state_shardings(state, mesh)
    if partition == "fsdp":
        return zero_state_shardings(state, mesh, shard_params=True)
    from style_transfer_based_holographic_imaging_tpu_torch.parallel.tp import (
        MODEL_AXIS,
        tp_state_shardings,
    )

    if partition in ("tp", "tp_fsdp") and MODEL_AXIS not in mesh.shape:
        raise ValueError(
            f"partition '{partition}' needs a '{MODEL_AXIS}' mesh axis; got axes "
            f"{tuple(mesh.axis_names)} — build the mesh with "
            f"make_mesh(n, axis_names=('data', 'model'), shape=(d, m))")
    if partition == "tp":
        return tp_state_shardings(state, mesh)
    if partition == "tp_fsdp":
        return merge_state_shardings(tp_state_shardings(state, mesh),
                                     zero_state_shardings(state, mesh, shard_params=True))
    raise ValueError(f"unknown partition {partition!r}; choose from {PARTITION_PLANS}")


def shard_state(state, shardings: Optional[Any], rank: int):
    """Rank ``rank``'s state of the whole ``state`` under the plan
    ``shardings`` (``None``: everything whole): each split leaf a contiguous
    copy of its shard, the rest copies."""

    def one(path, leaf, sh=None):
        if not torch.is_tensor(leaf):
            return leaf
        x = leaf if sh is None else sh.local(leaf, rank)
        return x.detach().clone(memory_format=torch.contiguous_format)

    if shardings is None:
        return tree_map_with_path(one, state)
    return tree_map_with_path(one, state, shardings)


def gather_state(local, shardings: Optional[Any]):
    """The whole state from every rank's shard of it (``shard_state``'s
    inverse): each split leaf all-gathered along its dims over their axes.
    A collective: every rank of the mesh calls it, with the same plan."""
    if shardings is None:
        return tree_map_with_path(lambda _, x: x, local)

    def one(path, leaf, sh):
        if not torch.is_tensor(leaf):
            return leaf
        groups = sh.mesh.groups()
        for axis, dim in sh.split_dims().items():
            leaf = all_gather(leaf, dim, groups[axis])
        return leaf.contiguous()

    return tree_map_with_path(one, local, shardings)
