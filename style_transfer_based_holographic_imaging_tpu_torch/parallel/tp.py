"""Tensor (channel) parallelism over a ``model`` mesh axis (port of the JAX
package's ``parallel/tp.py``).

The plan (``tp_state_shardings``) splits the output channels of every conv,
transposed conv and dense layer whose output channel count divides by the
axis, its bias alike; the other leaves stay whole. Adam's moments and the EMA
lie like their parameter, so the update needs no collective.

The JAX package commits that layout and lets GSPMD place the collectives.
Here a split layer is Megatron's column-parallel layer with ``gather_output``
(``column_parallel``): its input, whole on every rank of the ``model``
group, passes an identity whose backward all-reduces the input's gradient
over the group; the rank computes its own slice of output channels from the
whole input with its weight slice; then an all-gather along channels makes
the output whole again, and its backward keeps the rank's slice of the
gradient. Every activation between layers is whole, so instance norm, AdaIN,
the reflect pad, pooling and the losses run as on one device; a reflect conv
with the ``cuda`` backend runs its border ring on the rank's output slice.

The rule on the logical dims: output channels are dim 0 of the port's OIHW
conv and ``(O, I)`` dense kernels and of a bias, and dim 1 of a transposed
conv's ``(C_in, C_out, 2, 2)`` kernel (the JAX package's last dim, and dim 1
of the same transposed-conv layout).
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch import nn

from style_transfer_based_holographic_imaging_tpu_torch.parallel.mesh import (
    Mesh,
    NamedSharding,
    all_gather,
    all_reduce,
    replicated,
    tree_map_with_path,
)

__all__ = ["MODEL_AXIS", "tp_leaf_spec", "tp_shardings", "tp_shard_params", "tp_state_shardings",
           "column_parallel"]

MODEL_AXIS = "model"


def _out_dim(name: str, ndim: int) -> int:
    layer = name.split(".")[-2] if "." in name else ""
    return 1 if ndim == 4 and layer.startswith("up") else 0


def tp_leaf_spec(name: str, leaf: Any, axis_size: int, axis: str) -> tuple:
    """The spec of one parameter ``name``: its output-channel dim split over
    ``axis`` when it divides by ``axis_size``, else ``()`` (whole)."""
    shape = tuple(getattr(leaf, "shape", ()))
    if not shape:
        return ()
    i = _out_dim(name, len(shape))
    if shape[i] % axis_size == 0 and shape[i] >= axis_size:
        spec = [None] * len(shape)
        spec[i] = axis
        return tuple(spec)
    return ()


def tp_shardings(params: Dict[str, torch.Tensor], mesh: Mesh, axis: str = MODEL_AXIS):
    """``{name: NamedSharding}`` of a state dict: output channels over
    ``mesh[axis]`` for every divisible leaf, whole otherwise."""
    n = mesh.shape[axis]
    return {k: NamedSharding(mesh, tp_leaf_spec(k, v, n, axis)) for k, v in params.items()}


def tp_shard_params(params: Dict[str, torch.Tensor], mesh: Mesh, rank: int,
                    axis: str = MODEL_AXIS) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s slices of a state dict under ``tp_shardings``, on
    its mesh device."""
    dev = mesh.device_list[rank]
    sh = tp_shardings(params, mesh, axis)
    return {k: sh[k].local(v, rank).contiguous().to(dev) for k, v in params.items()}


def tp_state_shardings(state, mesh: Mesh, axis: str = MODEL_AXIS):
    """The plan of a whole ``train.state.TrainState``: the output-channel
    rule on every tensor (the moments and the EMA lie like their
    parameter), the step counts whole."""
    n = mesh.shape[axis]
    repl = replicated(mesh)

    def one(path, leaf):
        if not torch.is_tensor(leaf):
            return repl
        return NamedSharding(mesh, tp_leaf_spec(path[-1], leaf, n, axis))

    return tree_map_with_path(one, state)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; backward the sum of the input's gradient over the
    ``model`` group (each rank's output slice reaches the input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _GatherChannels(torch.autograd.Function):
    """All-gather of the ranks' output slices along dim 1; backward the
    rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, y, group, index):
        ctx.index, ctx.width = index, y.shape[1]
        return all_gather(y, 1, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return g.narrow(1, ctx.index * ctx.width, ctx.width).contiguous(), None, None


def column_parallel(root: nn.Module, shardings: Dict[str, NamedSharding], *,
                    axis: str = MODEL_AXIS, prefix: str = "") -> List[Any]:
    """Make each submodule of ``root`` whose ``weight`` (``prefix`` + its
    name) ``shardings`` splits over ``axis`` a column-parallel layer: a
    forward pre-hook on its input and a forward hook gathering its output
    (the module docstring). Its parameters must then be the rank's slices
    (``functional_call`` with the rank's state). Returns the hook handles."""
    handles = []
    for name, module in root.named_modules():
        sh = shardings.get(f"{prefix}{name}.weight" if name else f"{prefix}weight")
        if sh is None or axis not in sh.spec:
            continue
        group = sh.mesh.groups()[axis]
        index = sh.mesh.coords(torch.distributed.get_rank())[axis]

        def pre(_, args, group=group):
            return (_CopyToModel.apply(args[0], group),) + tuple(args[1:])

        def post(_, args, out, group=group, index=index):
            return _GatherChannels.apply(out, group, index)

        handles += [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]
    return handles
