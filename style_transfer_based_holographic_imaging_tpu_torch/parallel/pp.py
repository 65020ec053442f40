"""Pipeline parallelism: GPipe-scheduled retrieval and training over a
``pipe`` mesh axis (port of the JAX package's ``parallel/pp.py``).

The retrieval forward (stem -> VGG ladder -> AdaIN + distance head ->
decoder ladder, with the ``decoder_ph`` ladder after a ``stash`` rewind
when the params carry one) is flattened into a linear chain of layer ops
and split into ``mesh.shape['pipe']`` contiguous stages balanced by a FLOP
model (the exact linear partition); ``pipeline_plan`` is the JAX package's
name for name.

The JAX package runs every stage inside one SPMD program: the stages'
parameters packed into one ``(S, Pmax)`` array, the stage chosen by
``lax.switch``, the schedule a ``lax.scan`` whose transpose is the backward.
Here each rank of the axis is one stage in its own process:

* a rank builds only its stage, as modules over the chain's layers (the
  port's ``ReflectConv`` on its ``matpad`` border, ``ConvTranspose2x2``,
  ``max_pool_ceil``, the distance head, ``adain_with_stats``), and holds
  only that stage's parameters and, in training, only their Adam moments;
* activations cross a stage boundary as one flat fp32 buffer a microbatch,
  in lanes ``x | d | t | feat | g | stats`` (``_Boundary``, the JAX
  layout) of exactly that boundary's size;
* the schedule is GPipe over ``M + S - 1`` ticks: at tick ``t`` rank ``s``
  runs microbatch ``t - s`` when ``0 <= t - s < M`` and computes nothing in
  a bubble; every rank takes part in one ``ppermute`` a tick (an empty
  buffer in a bubble), so no collective waits on a rank that skipped it;
  the last stage's outputs reach every rank once, at the end, by one
  ``broadcast``;
* a pass is one ``torch.autograd.Function`` (``_GPipe``): its forward keeps
  each microbatch's local graph, its backward runs the ticks in reverse,
  each rank taking the gradient of its stage's outputs from the next stage
  by the inverse ``ppermute`` and returning its parameters' gradients.

**The replicated loss.** The last stage's output is broadcast, so every
rank computes the same loss and calls ``backward`` on it. The cotangent of
the broadcast output is taken from the last stage alone (the others'
identical copies are dropped): summed over the S ranks instead, as the
backward of an ``all_reduce`` would, every gradient would come out S times
too large. Likewise the gradient of a pass's input (the re-encoded image
of training's third pass) and of its per-sample style statistics reach
every rank by a ``broadcast`` from the stage that uses them, so that the
replicated graph upstream carries one copy.

Numerics are those of the one-process ``pipelines.retrieval_step`` and
``train.generator_loss_fn`` (fp32 throughout); the refocus and the
supervised target run through ``torch.fft`` (``asm_backend="torch"``),
as the JAX package's pipeline takes its ``"xla"`` backend.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from style_transfer_based_holographic_imaging_tpu_torch.config import PhysicsConfig
from style_transfer_based_holographic_imaging_tpu_torch.models.distance import DistanceMLP
from style_transfer_based_holographic_imaging_tpu_torch.models.layers import (
    ConvTranspose2x2,
    ReflectConv,
    max_pool_ceil,
)
from style_transfer_based_holographic_imaging_tpu_torch.models.net import (
    has_phase_decoder,
    style_stats_nchw,
)
from style_transfer_based_holographic_imaging_tpu_torch.models.vgg import _BLOCKS, scaled
from style_transfer_based_holographic_imaging_tpu_torch.ops.holo import holo_forward
from style_transfer_based_holographic_imaging_tpu_torch.ops.stats import adain_with_stats, calc_mean_std
from style_transfer_based_holographic_imaging_tpu_torch.parallel.mesh import Mesh, _ppermute

__all__ = [
    "PIPE_AXIS",
    "make_pipeline_retrieval_fn",
    "make_pipeline_finetune_fn",
    "make_pipeline_train_fn",
    "pipeline_plan",
    "stage_leaves",
]

PIPE_AXIS = "pipe"

# Decoder ladder (models/decoder.py): (name, base features, kind) in
# execution order. 'u' = ConvTranspose2x2, 'r' = reflect conv + relu,
# 'last' = reflect conv, no relu, fixed 2ch.
_DECODER: Tuple[Tuple[str, int, str], ...] = (
    ("conv0", 512, "r"),
    ("conv1", 256, "r"),
    ("up0", 256, "u"),
    ("conv2", 256, "r"),
    ("conv3", 256, "r"),
    ("conv4", 256, "r"),
    ("conv5", 128, "r"),
    ("up1", 128, "u"),
    ("conv6", 128, "r"),
    ("conv7", 64, "r"),
    ("up2", 64, "u"),
    ("conv8", 64, "r"),
    ("conv9", 64, "r"),
    ("conv10", 2, "last"),
)

_TAPS = ("conv1_1", "conv2_1", "conv3_1", "conv4_1")


@dataclasses.dataclass(frozen=True)
class _Layer:
    kind: str                      # 'stem' | 'rconv' | 'up' | 'adain' | 'stash'
    path: Tuple[str, ...]          # module path in the net
    relu: bool
    pool_before: bool
    in_shape: Tuple[int, int, int]   # activation (h, w, c) INTO this op
    out_shape: Tuple[int, int, int]
    flops: float


def _build_chain(image_size: int, width: float = 1.0, with_phase_decoder: bool = False) -> List[_Layer]:
    """The retrieval forward as a flat layer chain with static shapes
    (the JAX package's, shapes ``(h, w, c)``). ``with_phase_decoder``
    appends the ``decoder_ph`` ladder after a zero-param 'stash' op that
    parks the main decoder's output in the ``g`` lane and rewinds the
    activation to the AdaIN mixture ``t``: both decoders read the same
    ``t`` (``models/net.py`` ``field_retrieval``)."""

    def _decoder_ladder(layers, module, h, w, c):
        for name, feats, kind in _DECODER:
            ih, iw, ic = h, w, c
            if kind == "u":
                f = scaled(feats, width)
                h, w = h * 2, w * 2
                layers.append(_Layer("up", (module, name), True, False, (ih, iw, ic), (h, w, f),
                                     2.0 * h * w * ic * f))
            else:
                f = 2 if kind == "last" else scaled(feats, width)
                layers.append(_Layer("rconv", (module, name), kind != "last", False, (ih, iw, ic),
                                     (h, w, f), 2.0 * h * w * 9 * ic * f))
            c = f
        return h, w, c

    layers: List[_Layer] = []
    h = w = image_size
    c = 1
    layers.append(_Layer("stem", ("encoder", "stem"), False, False, (h, w, c), (h, w, 3), 2.0 * h * w * 3))
    c = 3
    for block in _BLOCKS:
        for name, feats, pool_before in block:
            ih, iw, ic = h, w, c
            if pool_before:
                h, w = -(-h // 2), -(-w // 2)
            f = scaled(feats, width)
            layers.append(_Layer("rconv", ("encoder", name), True, pool_before, (ih, iw, ic), (h, w, f),
                                 2.0 * h * w * 9 * ic * f))
            c = f
    # AdaIN mixing + distance head at the relu4_1 boundary. FLOPs: the
    # distance MLP's dense ladder.
    d_flops = 2.0 * (1024 * 1024 + 1024 * 1024 + 1024 * 512 + 512)
    layers.append(_Layer("adain", ("distance_g",), False, False, (h, w, c), (h, w, c), d_flops))
    t_shape = (h, w, c)
    h, w, c = _decoder_ladder(layers, "decoder", h, w, c)
    if with_phase_decoder:
        layers.append(_Layer("stash", ("stash",), False, False, (h, w, c), t_shape, float(np.prod(t_shape))))
        h, w, c = t_shape
        _decoder_ladder(layers, "decoder_ph", h, w, c)
    return layers


def _partition(chain: Sequence[_Layer], n_stages: int) -> List[List[_Layer]]:
    """Exact linear partition of the chain into ``n_stages`` contiguous
    groups minimising the max per-stage FLOPs (O(n^2 S) DP)."""
    n = len(chain)
    if not 1 <= n_stages <= n:
        raise ValueError(f"n_stages={n_stages} for a {n}-layer chain")
    cost = np.array([lay.flops for lay in chain])
    pref = np.concatenate([[0.0], np.cumsum(cost)])
    # dp[s][i] = best max-cost splitting chain[:i] into s stages.
    dp = np.full((n_stages + 1, n + 1), np.inf)
    cut = np.zeros((n_stages + 1, n + 1), np.int64)
    dp[0][0] = 0.0
    for s in range(1, n_stages + 1):
        for i in range(s, n + 1):
            for j in range(s - 1, i):
                v = max(dp[s - 1][j], pref[i] - pref[j])
                if v < dp[s][i]:
                    dp[s][i] = v
                    cut[s][i] = j
    bounds = [n]
    for s in range(n_stages, 0, -1):
        bounds.append(int(cut[s][bounds[-1]]))
    bounds = bounds[::-1]
    return [list(chain[bounds[s]:bounds[s + 1]]) for s in range(n_stages)]


def pipeline_plan(image_size: int, n_stages: int, width: float = 1.0,
                  with_phase_decoder: bool = False) -> List[List[str]]:
    """Human-readable stage assignment (layer names per stage)."""
    stages = _partition(_build_chain(image_size, width, with_phase_decoder), n_stages)
    return [["/".join(lay.path) for lay in st] for st in stages]


def _layer_leaf_shapes(layer: _Layer) -> List[Tuple[Tuple[str, ...], Tuple[int, ...]]]:
    """(relative param path, JAX shape) leaves of one layer op, in the JAX
    package's pack order."""
    ic, oc = layer.in_shape[2], layer.out_shape[2]
    if layer.kind == "stem":
        return [(("kernel",), (1, 1, ic, oc)), (("bias",), (oc,))]
    if layer.kind == "rconv":
        return [(("kernel",), (3, 3, ic, oc)), (("bias",), (oc,))]
    if layer.kind == "up":
        return [(("kernel",), (ic, oc, 2, 2)), (("bias",), (oc,))]
    if layer.kind == "adain":
        hidden = 1024
        dims = [(ic * 2, hidden), (hidden, hidden), (hidden, hidden // 2), (hidden // 2, 1)]
        out: List[Tuple[Tuple[str, ...], Tuple[int, ...]]] = []
        for name, (i, o) in zip(("l1", "l2", "l3", "out"), dims):
            out.append(((name, "kernel"), (i, o)))
            out.append(((name, "bias"), (o,)))
        return out
    if layer.kind == "stash":
        return []
    raise ValueError(layer.kind)


def stage_leaves(image_size: int, width: float, n_stages: int,
                 with_phase_decoder: bool = False) -> List[List[Tuple[Tuple[str, ...], Tuple[int, ...]]]]:
    """Each stage's parameters as (JAX path, JAX shape), in the order the
    JAX package packs them into its ``(S, Pmax)`` array
    (``_pack_stage_params``): the layers in chain order, each layer's
    leaves in ``_layer_leaf_shapes`` order, one after another from offset
    0; a stage without parameters holds one zero (the pack's placeholder).
    ``interop.from_jax.convert_pipeline_state`` reads it."""
    stages = _partition(_build_chain(image_size, width, with_phase_decoder), n_stages)
    return [[(lay.path + rel, shape) for lay in st for rel, shape in _layer_leaf_shapes(lay)]
            for st in stages]


# ---- the stage a rank runs ----


@dataclasses.dataclass(frozen=True)
class _Boundary:
    """Layout of one stage-boundary flat buffer, in lane order
    ``x | d | t | feat | g | stats`` (each lane a sample's values, NCHW
    order within it; shapes ``(c, h, w)``).

    * ``x`` — the running activation (always present).
    * ``d`` — the distance head's prediction (after the adain op).
    * ``t`` — the AdaIN mixture, carried where a later stage needs it: the
      ``decoder_ph`` rewind ('stash') or the training loss (content target).
    * ``feat`` — the pre-AdaIN relu4_1 features (training: the re-encode
      pass's content-loss operand).
    * ``g`` — the main decoder's parked output while ``decoder_ph`` runs.
    * ``stats`` — per-sample (mu, sigma) of the four encoder taps
      (training: the style-loss operands).
    """

    x: Tuple[int, int, int]
    d: bool = False
    t: Optional[Tuple[int, int, int]] = None
    feat: Optional[Tuple[int, int, int]] = None
    g: Optional[Tuple[int, int, int]] = None
    stats: int = 0

    def offsets(self) -> Tuple[Dict[str, Tuple[int, Tuple[int, ...]]], int]:
        out: Dict[str, Tuple[int, Tuple[int, ...]]] = {"x": (0, tuple(self.x))}
        pos = int(np.prod(self.x))
        if self.d:
            out["d"] = (pos, (1,))
            pos += 1
        for name in ("t", "feat", "g"):
            shp = getattr(self, name)
            if shp is not None:
                out[name] = (pos, tuple(shp))
                pos += int(np.prod(shp))
        if self.stats:
            out["stats"] = (pos, (self.stats,))
            pos += self.stats
        return out, pos

    def size(self) -> int:
        return self.offsets()[1]


def _take_lane(buf: torch.Tensor, layout, name: str) -> torch.Tensor:
    off, shp = layout[name]
    n = int(np.prod(shp))
    return buf[:, off:off + n].reshape((buf.shape[0],) + shp)


def _chw(hwc: Tuple[int, int, int]) -> Tuple[int, int, int]:
    return (hwc[2], hwc[0], hwc[1])


class _Stage(nn.Module):
    """One stage's layers as modules, under the names of the net's state
    dict (``encoder.conv1_1.weight``, ``distance_g.l1.bias``, ...), and its
    forward from the flat input buffer to the flat output buffer."""

    def __init__(self, layers: Sequence[_Layer], in_b: _Boundary, out_b: _Boundary,
                 tap_info: Dict[str, Tuple[int, int]]):
        super().__init__()
        self.layers, self.out_b, self.tap_info = list(layers), out_b, tap_info
        self.in_layout = in_b.offsets()[0]
        for lay in layers:
            ic, oc = lay.in_shape[2], lay.out_shape[2]
            if lay.kind == "stem":
                mod = nn.Conv2d(ic, oc, 1)
            elif lay.kind == "rconv":
                mod = ReflectConv(ic, oc)
            elif lay.kind == "up":
                mod = ConvTranspose2x2(ic, oc)
            elif lay.kind == "adain":
                mod = DistanceMLP(ic)
            else:
                continue
            parent = self
            for name in lay.path[:-1]:
                if not hasattr(parent, name):
                    parent.add_module(name, nn.Module())
                parent = getattr(parent, name)
            parent.add_module(lay.path[-1], mod)

    def _module(self, lay: _Layer) -> nn.Module:
        mod = self
        for name in lay.path:
            mod = getattr(mod, name)
        return mod

    def forward(self, buf: torch.Tensor, sm: torch.Tensor, ss: torch.Tensor, alpha: float) -> torch.Tensor:
        mb = buf.shape[0]
        lanes = {k: _take_lane(buf, self.in_layout, k) for k in self.in_layout}
        x = lanes["x"]
        d, t, feat, g = (lanes.get(k) for k in ("d", "t", "feat", "g"))
        stats = lanes.get("stats")
        if stats is None and self.out_b.stats:
            stats = torch.zeros((mb, self.out_b.stats), dtype=buf.dtype, device=buf.device)
        for lay in self.layers:
            if lay.pool_before:
                x = max_pool_ceil(x, 2, 2)
            if lay.kind == "stem":
                x = self._module(lay)(x)
            elif lay.kind == "rconv":
                x = self._module(lay)(x)
                if lay.relu:
                    x = F.relu(x)
                if stats is not None and lay.path[0] == "encoder" and lay.path[1] in self.tap_info:
                    o, ch = self.tap_info[lay.path[1]]
                    mean, std = calc_mean_std(x)
                    stats = stats.clone()
                    stats[:, o:o + ch] = mean.reshape(mb, ch)
                    stats[:, o + ch:o + 2 * ch] = std.reshape(mb, ch)
            elif lay.kind == "up":
                x = F.relu(self._module(lay)(x))
            elif lay.kind == "adain":
                d = self._module(lay)(calc_mean_std(x))
                feat = x
                x = alpha * adain_with_stats(x, sm, ss) + (1.0 - alpha) * x
                t = x
            elif lay.kind == "stash":
                # Park the main decoder's output, rewind to the AdaIN mixture
                # for the decoder_ph ladder.
                g, x = x, t
        parts = [x.reshape(mb, -1)]
        for name, val in (("d", d), ("t", t), ("feat", feat), ("g", g), ("stats", stats)):
            if getattr(self.out_b, name):
                parts.append(val.reshape(mb, -1))
        return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


class _Pipeline:
    """This rank's side of the pipeline over ``mesh[axis]``: the chain, its
    partition and boundaries, this rank's stage on its device, and the
    GPipe pass (``run``). Every rank of the axis builds one, at the same
    point."""

    def __init__(self, params: Dict[str, torch.Tensor], mesh: Mesh, *, n_micro: int, image_size: int,
                 width: float, axis: str, train_taps: bool = False):
        rank = dist.get_rank()
        self.device = mesh.device_list[rank]
        self.group = mesh.groups()[axis]
        self.n_stages = int(mesh.shape[axis])
        self.stage = mesh.coords(rank)[axis]
        self.peers = mesh.axis_ranks(axis, rank)     # the world rank of each stage
        self.n_micro = n_micro
        self.has_phase = has_phase_decoder(params)
        chain = _build_chain(image_size, width, self.has_phase)
        stages = _partition(chain, self.n_stages)
        self.plan = [["/".join(lay.path) for lay in st] for st in stages]

        adain_idx = next(i for i, lay in enumerate(chain) if lay.kind == "adain")
        stash_idx = next((i for i, lay in enumerate(chain) if lay.kind == "stash"), None)
        t_shape = _chw(chain[adain_idx].out_shape)
        g_shape = _chw(chain[stash_idx].in_shape) if stash_idx is not None else None
        tap_info: Dict[str, Tuple[int, int]] = {}
        stats_total = 0
        if train_taps:
            for lay in chain:
                if lay.path[0] == "encoder" and lay.path[1] in _TAPS:
                    tap_info[lay.path[1]] = (stats_total, lay.out_shape[2])
                    stats_total += 2 * lay.out_shape[2]
        starts = np.concatenate([[0], np.cumsum([len(st) for st in stages])]).astype(int).tolist()

        def bound(pidx: int) -> _Boundary:
            """The lanes before chain layer ``pidx`` (``len(chain)``: the output)."""
            x = chain[pidx].in_shape if pidx < len(chain) else chain[-1].out_shape
            after_adain = pidx > adain_idx
            keep_t = after_adain and (train_taps or (stash_idx is not None and pidx <= stash_idx))
            return _Boundary(
                x=_chw(x), d=after_adain, t=t_shape if keep_t else None,
                feat=t_shape if (train_taps and after_adain) else None,
                g=g_shape if (stash_idx is not None and pidx > stash_idx) else None,
                stats=stats_total if (train_taps and pidx > 0) else 0)

        self.in_bounds = [bound(starts[i]) for i in range(self.n_stages)]
        self.out_bounds = [bound(starts[i + 1]) for i in range(self.n_stages)]
        self.out_layout = self.out_bounds[-1].offsets()[0]
        self.tap_info, self.stats_total, self.c4 = tap_info, stats_total, t_shape[0]
        self.adain_stage = next(i for i, st in enumerate(stages) if any(lay.kind == "adain" for lay in st))
        s = self.stage
        self.module = _Stage(stages[s], self.in_bounds[s], self.out_bounds[s], tap_info).to(self.device)
        mine = {k: params[k] for k in self.module.state_dict()}
        self.module.load_state_dict(mine, strict=True)
        self.module.requires_grad_(False)
        self.names = [k for k, _ in self.module.named_parameters()]
        # A stage may hold no parameters (a lone 'stash'): its pass still
        # needs an input that asks for a gradient, so that its backward runs
        # (each rank's backward takes part in the ring).
        self.anchor = torch.zeros((), device=self.device, requires_grad=True)

    def stage_params(self) -> Dict[str, torch.Tensor]:
        """This rank's stage's parameters (the module's, on its device)."""
        return {k: v.detach() for k, v in self.module.named_parameters()}

    def run(self, x: torch.Tensor, sm: torch.Tensor, ss: torch.Tensor, alpha: float,
            params: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """One pipelined pass over the batch ``x`` (``(B, 1, H, W)``, the
        same on every rank): the output boundary's flat buffer ``(B, size)``
        on every rank. ``params`` (this stage's, by name) replaces the
        module's and makes the pass differentiable, as does an ``x``, ``sm``
        or ``ss`` that asks for a gradient: a choice every rank makes alike
        (a stage without parameters too), since every rank's backward takes
        part in the ring."""
        train = params is not None or any(t.requires_grad for t in (x, sm, ss))
        params = self.stage_params() if params is None else params
        tensors = [params[k] for k in self.names]
        if torch.is_grad_enabled() and train:
            return _GPipe.apply(self, float(alpha), x, sm, ss, self.anchor, *tensors)
        with torch.no_grad():
            return self._forward(x, sm, ss, float(alpha), tensors, keep=False)[0]

    # -- the schedule --

    def _call(self, buf, sm, ss, alpha, tensors):
        return functional_call(self.module, dict(zip(self.names, tensors)), (buf, sm, ss, alpha))

    def _forward(self, x, sm, ss, alpha, tensors, keep: bool, needs=(False, False, False)):
        S, s, M = self.n_stages, self.stage, self.n_micro
        batch = x.shape[0]
        mb = batch // M
        per_sample = sm.shape[0] == batch and batch > 1
        perm = [(i, i + 1) for i in range(S - 1)]
        in_size, out_size = self.in_bounds[s].size(), self.out_bounds[s].size()
        records, outs = [None] * M, []
        recv = None
        for t in range(M + S - 1):
            m = t - s
            send = x.new_empty((0,))
            if 0 <= m < M:
                rows = slice(m * mb, (m + 1) * mb)
                inp = x[rows].reshape(mb, -1) if s == 0 else recv
                sm_t, ss_t = (sm[rows], ss[rows]) if per_sample else (sm, ss)
                if keep:
                    inp = inp.detach().requires_grad_(s > 0 or needs[0])
                    sm_t = sm_t.detach().requires_grad_(needs[1])
                    ss_t = ss_t.detach().requires_grad_(needs[2])
                    with torch.enable_grad():
                        y = self._call(inp, sm_t, ss_t, alpha, tensors)
                    records[m] = (inp, sm_t, ss_t, y)
                else:
                    y = self._call(inp, sm_t, ss_t, alpha, tensors)
                send = y.detach()
                if s == S - 1:
                    outs.append(send)
            # stage s - 1 sends microbatch t - (s - 1) at this tick
            m_in = t - (s - 1)
            shape = (mb, in_size) if s > 0 and 0 <= m_in < M else (0,)
            recv = _ppermute(send, perm, self.group, shape)
        final = self.out_bounds[-1].size()
        out = torch.cat(outs) if s == S - 1 else x.new_empty((batch, final))
        dist.broadcast(out, src=self.peers[S - 1], group=self.group)
        return out, records, per_sample

    def _backward(self, records, g_out, x, sm, ss, per_sample, leaves, needs):
        S, s, M = self.n_stages, self.stage, self.n_micro
        batch = g_out.shape[0]
        mb = batch // M
        inverse = [(i + 1, i) for i in range(S - 1)]
        out_size = self.out_bounds[s].size()
        g_params = [None] * len(leaves)
        gx = torch.zeros_like(x) if needs[0] else None
        g_style = [torch.zeros_like(sm) if needs[1] else None, torch.zeros_like(ss) if needs[2] else None]
        grecv = None
        for t in reversed(range(M + S - 1)):
            m = t - s
            send = g_out.new_empty((0,))
            if 0 <= m < M:
                inp, sm_t, ss_t, y = records[m]
                records[m] = None
                gy = g_out[m * mb:(m + 1) * mb] if s == S - 1 else grecv
                wrt = [v for v in (inp, sm_t, ss_t) if v.requires_grad] + list(leaves)
                grads = torch.autograd.grad(y, wrt, gy, allow_unused=True)
                got = dict(zip([id(v) for v in wrt], grads))
                for i, p in enumerate(leaves):
                    gp = got[id(p)]
                    if gp is not None:
                        g_params[i] = gp if g_params[i] is None else g_params[i] + gp
                g_inp = got.get(id(inp))
                if s > 0:
                    send = g_inp
                elif gx is not None:
                    gx[m * mb:(m + 1) * mb] = g_inp.view_as(gx[m * mb:(m + 1) * mb])
                for j, leaf in ((0, sm_t), (1, ss_t)):
                    gs = got.get(id(leaf)) if leaf.requires_grad else None
                    if g_style[j] is not None and gs is not None:
                        if per_sample:
                            g_style[j][m * mb:(m + 1) * mb] += gs
                        else:
                            g_style[j] += gs
            # stage s + 1 sends back the gradient of microbatch t - (s + 1)
            m_out = t - (s + 1)
            shape = (mb, out_size) if s < S - 1 and 0 <= m_out < M else (0,)
            grecv = _ppermute(send, inverse, self.group, shape)
        if gx is not None:
            dist.broadcast(gx, src=self.peers[0], group=self.group)
        for gs in g_style:
            if gs is not None:
                dist.broadcast(gs, src=self.peers[self.adain_stage], group=self.group)
        return gx, g_style[0], g_style[1], g_params


class _GPipe(torch.autograd.Function):
    """One pipelined pass (``_Pipeline.run``): forward the GPipe ticks,
    keeping each microbatch's local graph; backward the ticks in reverse.
    Inputs: the pipeline, alpha, x, sm, ss, the anchor, this stage's
    parameters (in ``_Pipeline.names`` order)."""

    @staticmethod
    def forward(ctx, pipe, alpha, x, sm, ss, anchor, *tensors):
        needs = tuple(ctx.needs_input_grad[2:5])
        leaves = [t.detach().requires_grad_(True) for t in tensors]
        out, records, per_sample = pipe._forward(x, sm, ss, alpha, leaves, keep=True, needs=needs)
        ctx.pipe, ctx.records, ctx.per_sample, ctx.needs, ctx.leaves = pipe, records, per_sample, needs, leaves
        ctx.save_for_backward(x, sm, ss)
        return out

    @staticmethod
    def backward(ctx, g_out):
        x, sm, ss = ctx.saved_tensors
        gx, gsm, gss, g_params = ctx.pipe._backward(ctx.records, g_out.contiguous(), x, sm, ss,
                                                    ctx.per_sample, ctx.leaves, ctx.needs)
        ctx.records = ctx.leaves = None
        return (None, None, gx, gsm, gss, None) + tuple(g_params)


# ---- the entry points ----


def _fields(pipe: _Pipeline, outs: torch.Tensor):
    """(amp, phase) ``(B, 1, H, W)`` of a pass's output: with ``decoder_ph``
    the phase is channel 0 of its ladder (the ``x`` lane) and the amplitude
    the main decoder's parked in ``g``."""
    xo = _take_lane(outs, pipe.out_layout, "x")
    if pipe.has_phase:
        return _take_lane(outs, pipe.out_layout, "g")[:, 0:1], xo[:, 0:1]
    return xo[:, 0:1], xo[:, 1:2]


def _check_batch(batch: int, n_micro: int) -> None:
    if batch % n_micro:
        raise ValueError(f"batch {batch} not divisible by n_micro={n_micro}")


def _adam(params, m, v, t, grads, lr: float):
    """The plain bias-corrected Adam of the JAX package's pipeline steps
    (b1, b2, eps = 0.9, 0.999, 1e-8; ``t`` an fp32 count), not optax's:
    new (params, m, v, t)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    t = t + 1
    m = {k: b1 * m[k] + (1.0 - b1) * grads[k] for k in params}
    v = {k: b2 * v[k] + (1.0 - b2) * grads[k] * grads[k] for k in params}
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=t.device), t)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=t.device), t)
    params = {k: params[k] - lr * (m[k] / c1) / (torch.sqrt(v[k] / c2) + eps) for k in params}
    return params, m, v, t


def _zeros_like(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros_like(v) for k, v in tree.items()}


def _to(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in batch.items()}


def _grads_of(loss, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """d loss / d params, zeros for a leaf the loss does not reach."""
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), grads)}


def make_pipeline_retrieval_fn(params: Dict[str, torch.Tensor], mesh: Mesh, *, n_micro: int, image_size: int,
                               physics: Optional[PhysicsConfig] = None, alpha: float = 1.0,
                               width: float = 1.0, unwrap: bool = True, axis: str = PIPE_AXIS):
    """A pipeline-parallel retrieval step over ``mesh[axis]``, in this rank
    of the mesh's world (every rank of the axis calls this, then the step,
    at the same points).

    Args:
      params: the net's state dict (``init_net_params`` / ``convert_params``
        layout); the rank keeps its stage's parameters, on its device.
      n_micro: GPipe microbatch count ``M`` (the batch must divide by it);
        the bubble fraction is ``(S-1)/(M+S-1)``.
      image_size: the hologram side (the chain's shapes hang off it).
      physics: when given, the step also refocuses by ``-d_style`` and
        returns ``pipelines.retrieval_step``'s dict; otherwise the
        style-plane fields and the distance.

    Returns ``fn(content_holo, style_mean, style_std[, d_style])``, the
    same dict on every rank, on the rank's device; ``fn.stages`` is the
    executed plan, ``fn.stage_params`` this rank's parameters.
    """
    pipe = _Pipeline(params, mesh, n_micro=n_micro, image_size=image_size, width=width, axis=axis)

    def fn(content_holo, style_mean, style_std, d_style: float = 0.2):
        f32 = dict(dtype=torch.float32, device=pipe.device)
        content = torch.sqrt(torch.as_tensor(content_holo, **f32))
        _check_batch(content.shape[0], n_micro)
        sm = style_stats_nchw(torch.as_tensor(style_mean, **f32))
        ss = style_stats_nchw(torch.as_tensor(style_std, **f32))
        with torch.no_grad():
            outs = pipe.run(content, sm, ss, alpha)
            amp, ph = _fields(pipe, outs)
            result = {"amp_field": amp, "ph_field": ph,
                      "distance_pred": _take_lane(outs, pipe.out_layout, "d").reshape(-1, 1, 1, 1)}
            if physics is not None:
                refocus_d = float(-np.float32(d_style) - np.float32(2.0 * physics.distance_normalize_constant))
                # torch.fft, as the JAX package's pipeline takes its "xla" backend
                result["amp_foc"], result["ph_foc"] = holo_forward(
                    amp, ph * float(np.float32(physics.phase_normalize)), refocus_d, physics,
                    return_field=True, unwrap=unwrap, asm_backend="torch")
        return result

    fn.stages = pipe.plan
    fn.stage_params = pipe.stage_params()
    return fn


def make_pipeline_finetune_fn(params: Dict[str, torch.Tensor], mesh: Mesh, *, n_micro: int, image_size: int,
                              physics: PhysicsConfig, lr: float = 2e-5, distance_weight: float = 10.0,
                              alpha: float = 1.0, width: float = 1.0, axis: str = PIPE_AXIS):
    """Pipeline-parallel supervised fine-tune: the GPipe forward and
    backward, and the plain Adam on each rank's stage.

    The objective is the retrieval path's supervised loss at a fixed style
    vector: the style-plane fields against the targets propagated from the
    known objects (``train.losses.style_plane_target``), plus
    ``distance_weight`` times the content distance's MSE.

    Returns ``(step_fn, state0)``: ``state0 = (params, m, v, t)``, this
    rank's stage's parameters and moments by name and the fp32 step count;
    ``step_fn(state, batch, sm, ss) -> (state, metrics)`` with ``batch`` a
    ``data.synth.synth_batch(return_gt=True)`` dict (NCHW), the same on
    every rank; with ``with_grads=True`` it also returns this stage's
    gradients of the step (by name).
    """
    from style_transfer_based_holographic_imaging_tpu_torch.train.losses import (
        distance_loss,
        style_plane_target,
    )

    pipe = _Pipeline(params, mesh, n_micro=n_micro, image_size=image_size, width=width, axis=axis)

    def loss_and_grads(state, batch, sm, ss):
        sp = {k: v.detach().requires_grad_(True) for k, v in state[0].items()}
        batch = _to(batch, pipe.device)
        _check_batch(batch["content_holo"].shape[0], n_micro)
        sm = style_stats_nchw(torch.as_tensor(sm, dtype=torch.float32, device=pipe.device))
        ss = style_stats_nchw(torch.as_tensor(ss, dtype=torch.float32, device=pipe.device))
        outs = pipe.run(batch["content_holo"], sm, ss, alpha, sp)
        amp, ph = _fields(pipe, outs)
        d_pred = _take_lane(outs, pipe.out_layout, "d")
        gt_amp, gt_ph = style_plane_target(batch["amplitude"], batch["phase_content"],
                                           batch["distance_style"], physics)
        gt_ph = gt_ph / physics.phase_normalize
        l_sup = torch.mean((amp - gt_amp) ** 2) + torch.mean((ph - gt_ph) ** 2)
        l_d = distance_loss(d_pred, batch["distance_content"])
        loss = l_sup + distance_weight * l_d
        grads = _grads_of(loss, sp)
        aux = {"loss_supervised": l_sup.detach(), "loss_distance": l_d.detach(), "loss_total": loss.detach()}
        return loss.detach(), aux, grads

    def step_fn(state, batch, sm, ss, *, with_grads: bool = False):
        _, aux, grads = loss_and_grads(state, batch, sm, ss)
        with torch.no_grad():
            new = _adam(*state, grads, lr)
        return (new, aux, grads) if with_grads else (new, aux)

    step_fn.stages = pipe.plan
    sp = pipe.stage_params()
    return step_fn, (sp, _zeros_like(sp), _zeros_like(sp), torch.zeros((), dtype=torch.float32,
                                                                        device=pipe.device))


def make_pipeline_train_fn(params: Dict[str, torch.Tensor], mesh: Mesh, *, n_micro: int, image_size: int,
                           physics: PhysicsConfig, cfg, lr: Optional[float] = None, alpha: float = 1.0,
                           width: float = 1.0, axis: str = PIPE_AXIS, disc: Optional[nn.Module] = None,
                           disc_params: Optional[Dict[str, torch.Tensor]] = None):
    """Pipeline-parallel full training step: the reconstructed scheme
    (content + style + physics cycle + distance [+ supervised] [+ TV]
    [+ adversarial]) through the GPipe schedule, three passes a step, each
    differentiating into this rank's stage:

      1. style pass: alpha 0 (no AdaIN mix) encodes the style holograms,
         taps the per-sample (mu, sigma) of relu1_1..relu4_1 into the stats
         lane (the style-loss targets) and predicts d_style;
      2. content pass: the relu4_1 part of the style statistics feeds AdaIN
         per sample; it gives g_t (and the decoder_ph phase when present),
         d_content and the mixture t (the content-loss target);
      3. re-encode pass: g_t's amplitude through the pipeline again; its
         pre-AdaIN relu4_1 features (the feat lane) and statistics are the
         content- and style-loss operands.

    The physics cycle, distance, supervised and TV terms are those of
    ``train.generator_loss_fn``, on the broadcast outputs. The optional
    LSGAN discriminator (``disc``, ``disc_params``, ``cfg.adv_weight``) is
    replicated: every rank steps its own copy from the same values, with
    its own Adam, and no collective. ``cfg`` is a ``TrainConfig`` (its
    weights, and its lr unless ``lr`` is given); ``perceptual_weight`` is
    refused.

    Returns ``(step_fn, state0)``, ``state0 = (params, m, v, t,
    disc_params, disc_m, disc_v)``, and ``step_fn(state, batch) -> (state,
    metrics)``; ``batch`` is a ``data.synth.synth_batch`` dict (NCHW), with
    the ground-truth fields when ``cfg.supervised_weight``; with
    ``with_grads=True`` it also returns this stage's gradients of the step
    (by name).
    """
    from style_transfer_based_holographic_imaging_tpu_torch.train.losses import (
        distance_loss,
        lsgan_d_loss,
        lsgan_g_loss,
        physics_cycle_loss,
        style_plane_target,
        tv_loss,
    )

    if getattr(cfg, "perceptual_weight", 0.0):
        raise ValueError(
            "perceptual_weight is not plumbed through the pipelined loss program (it needs a 4th "
            "encoder pass); train with the DP/FSDP/TP paths, or set perceptual_weight=0 for PP")
    lr = float(cfg.lr if lr is None else lr)
    pipe = _Pipeline(params, mesh, n_micro=n_micro, image_size=image_size, width=width, axis=axis,
                     train_taps=True)
    layout, tap_info, c4 = pipe.out_layout, pipe.tap_info, pipe.c4
    s4 = tap_info["conv4_1"][0]
    use_adv = bool(cfg.adv_weight) and disc is not None
    if disc is not None:
        disc = disc.to(pipe.device)
    dev = pipe.device

    def loss_fn(sp, dp, batch):
        content, style = batch["content_holo"], batch["style_holo"]
        b = content.shape[0]
        _check_batch(b, n_micro)
        sm0 = torch.zeros((1, c4, 1, 1), device=dev)
        ss0 = torch.ones((1, c4, 1, 1), device=dev)

        # pass 1: style encode (alpha 0: no AdaIN mix)
        outs_s = pipe.run(style, sm0, ss0, 0.0, sp)
        stats_s = _take_lane(outs_s, layout, "stats")
        d_s_pred = _take_lane(outs_s, layout, "d")
        sm_b = stats_s[:, s4:s4 + c4].reshape(b, c4, 1, 1)
        ss_b = stats_s[:, s4 + c4:s4 + 2 * c4].reshape(b, c4, 1, 1)

        # pass 2: content retrieval with the per-sample style statistics
        outs_c = pipe.run(content, sm_b, ss_b, alpha, sp)
        amp_t, ph_t = _fields(pipe, outs_c)
        d_c_pred = _take_lane(outs_c, layout, "d")
        t_mix = _take_lane(outs_c, layout, "t")

        # pass 3: re-encode g_t (its amplitude)
        outs_g = pipe.run(amp_t, sm0, ss0, 0.0, sp)
        feat_g = _take_lane(outs_g, layout, "feat")
        stats_g = _take_lane(outs_g, layout, "stats")

        loss_c = torch.mean((feat_g - t_mix.detach()) ** 2)
        loss_s = torch.zeros((), device=dev)
        sg_stats_s = stats_s.detach()
        for off, ch in tap_info.values():
            loss_s = loss_s + torch.mean((stats_g[:, off:off + ch] - sg_stats_s[:, off:off + ch]) ** 2)
            loss_s = loss_s + torch.mean(
                (stats_g[:, off + ch:off + 2 * ch] - sg_stats_s[:, off + ch:off + 2 * ch]) ** 2)
        loss = cfg.content_weight * loss_c + cfg.style_weight * loss_s
        aux = {"loss_content": loss_c, "loss_style": loss_s}
        if cfg.physics_weight:
            l_phy = physics_cycle_loss(amp_t, ph_t, d_c_pred.reshape(-1, 1, 1, 1), batch["distance_style"],
                                       content, physics)
            loss = loss + cfg.physics_weight * l_phy
            aux["loss_physics"] = l_phy
        if cfg.distance_weight:
            l_d = distance_loss(d_s_pred, batch["distance_style"]) + distance_loss(d_c_pred,
                                                                                    batch["distance_content"])
            loss = loss + cfg.distance_weight * l_d
            aux["loss_distance"] = l_d
        if cfg.supervised_weight and "phase_content" in batch:
            gt_amp, gt_ph = style_plane_target(batch["amplitude"], batch["phase_content"],
                                               batch["distance_style"], physics)
            gt_ph = gt_ph / physics.phase_normalize
            l_sup = torch.mean((amp_t - gt_amp) ** 2) + torch.mean((ph_t - gt_ph) ** 2)
            loss = loss + cfg.supervised_weight * l_sup
            aux["loss_supervised"] = l_sup
        if cfg.tv_weight:
            l_tv = tv_loss(ph_t)
            loss = loss + cfg.tv_weight * l_tv
            aux["loss_tv"] = l_tv
        if use_adv:
            fake_logits, _ = functional_call(disc, dp, (amp_t,))
            l_adv = lsgan_g_loss(fake_logits)
            loss = loss + cfg.adv_weight * l_adv
            aux["loss_adv"] = l_adv
        aux["loss_total"] = loss
        return loss, aux, amp_t

    def loss_and_grads(state, batch):
        sp = {k: v.detach().requires_grad_(True) for k, v in state[0].items()}
        batch = _to(batch, dev)
        loss, aux, amp_t = loss_fn(sp, state[4], batch)
        grads = _grads_of(loss, sp)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads, amp_t.detach(), batch

    def step_fn(state, batch, *, with_grads: bool = False):
        sp, m, v, t, dp, dm, dv = state
        _, aux, grads, fake, batch = loss_and_grads(state, batch)
        with torch.no_grad():
            sp, m, v, t = _adam(sp, m, v, t, grads, lr)
        if use_adv:
            dpg = {k: p.detach().requires_grad_(True) for k, p in dp.items()}
            real_logits, _ = functional_call(disc, dpg, (batch["style_holo"],))
            fake_logits, _ = functional_call(disc, dpg, (fake,))
            d_loss = lsgan_d_loss(real_logits, fake_logits)
            d_grads = _grads_of(d_loss, dpg)
            with torch.no_grad():
                # the generator's count, as the JAX step takes it
                dp, dm, dv, _ = _adam(dp, dm, dv, t - 1, d_grads, lr)
            aux["loss_disc"] = d_loss.detach()
        new = (sp, m, v, t, dp, dm, dv)
        return (new, aux, grads) if with_grads else (new, aux)

    step_fn.stages = pipe.plan
    sp = pipe.stage_params()
    dp = {} if disc_params is None else {k: torch.as_tensor(v, dtype=torch.float32).to(dev)
                                         for k, v in disc_params.items()}
    state0 = (sp, _zeros_like(sp), _zeros_like(sp), torch.zeros((), dtype=torch.float32, device=dev),
              dp, _zeros_like(dp), _zeros_like(dp))
    return step_fn, state0
