"""The port's mesh layer (``parallel/``) on the CPU, in spawned ``gloo``
worlds, against the port's one-process step and the JAX package's mesh step
on its 8-virtual-device CPU mesh.

Width 0.25, 64^2 (the golden train-split digits at 32^2, padded by 16), a
global batch of 4 (the JAX package's ``synth_batch`` with key 5), the default
``TrainConfig`` (the encoder frozen, invtime) without the adversarial term
and without the clip unless a case says otherwise (the default clip of 1.0
lies below this step's norm and would hide a gradient scaled on every rank;
the clip cases set 1e-3). Two worlds of ranks on the CPU, one
thread each, spawned once per module (``tests/torch_parallel_world.py``
runs in them): two ranks for ``dp`` (with and without ``tv_weight``, and
with ``grad_accum`` 2 and dropout, with the default clip and without), ``zero1``, ``fsdp`` (with the
adversarial term and EMA), ``tp`` on a (1, 2) mesh, the clip under ``dp``,
``fsdp`` and ``tp``, and ``train(partition="fsdp")``; four for ``tp_fsdp`` on (2, 2) (with the adversarial term, the
EMA and the encoder trained). Each world has a time limit: a
hung collective fails its fixture (``parallel.launch`` kills the ranks).

Tolerances:

* a mesh step against the port's one-process step, the JAX package's
  ``tests/test_parallel.py`` rules: ``dp`` loss within 2e-5 relative, params
  ``rtol=1e-4, atol=1e-6`` (its 1-device against 8-device step); the other
  partitions |dloss| < 1e-5 and params within 2e-5 (its ZeRO, FSDP and TP
  tests). The ``tv_weight`` case names where a split could part: the TV term
  sums over the batch, so each rank's loss is its share of the global loss
  (the means scaled by its share, the sum not);
* against the JAX package's ``make_train_step(mesh=make_mesh(2))`` step,
  with and without ``tv_weight``: the loss within 2e-5 relative; the params within 1e-4 of each leaf's max plus
  0.1 lr (``tests/test_torch_train.py``'s rule for the port's steps against
  the JAX package's): elements whose gradient is near Adam's eps take steps
  of a few hundredths of lr apart between the two packages, 1.2e-6 here in
  the distance head, past an ``atol`` of 1e-6;
* Adam's first moments after a step (0.1 times the gradient), in every
  step test beside the params: within 1e-4 of each leaf's max. The params
  after Adam's first step (about lr times the gradient's sign) and any
  step under a clip that acts are blind to a gradient that comes out N
  times too large or too small on every rank; these moments are not;
* the logical-dim map: the same dim (in the JAX layout) split over the same
  axis, leaf for leaf, for every plan on the mesh shapes 2, 4 and 2 x 2;
* serving and streaming over a 2-device mesh against one device: ``ph_foc``
  within 2e-4 (``tests/test_parallel.py``'s sharded inference).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_cpu_threads import warm_few_torch_threads  # noqa: F401
from torch_parallel_world import (
    BASE_TRAIN,
    CASES,
    DATA,
    DISC,
    IMAGE,
    LEAF,
    WIDTH,
    run_config,
    step_once,
    train_config,
    world_checks,
)

from style_transfer_based_holographic_imaging_tpu.config import TrainConfig as JTrainConfig
from style_transfer_based_holographic_imaging_tpu.data import load_golden_suite as j_load_goldens
from style_transfer_based_holographic_imaging_tpu.data import synth as jsynth
from style_transfer_based_holographic_imaging_tpu.models import StyleTransferNet as JNet
from style_transfer_based_holographic_imaging_tpu.parallel import make_mesh as j_make_mesh
from style_transfer_based_holographic_imaging_tpu.parallel import (
    partition_state_shardings as j_partition,
)
from style_transfer_based_holographic_imaging_tpu.parallel import shard_batch as j_shard_batch
from style_transfer_based_holographic_imaging_tpu.config import PhysicsConfig as JPhysics
from style_transfer_based_holographic_imaging_tpu.train import create_train_state as j_create
from style_transfer_based_holographic_imaging_tpu.train import make_train_step as j_make_step
from style_transfer_based_holographic_imaging_tpu_torch.config import ExperimentConfig, ModelConfig
from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite
from style_transfer_based_holographic_imaging_tpu_torch.interop import convert_params
from style_transfer_based_holographic_imaging_tpu_torch.interop.from_jax import (
    _adam_state,
    _convert_adam,
    _convert_leaf,
    _flatten,
)
from style_transfer_based_holographic_imaging_tpu_torch.models import PatchDiscriminator, init_net_params, init_params
from style_transfer_based_holographic_imaging_tpu_torch.parallel import (
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    launch,
    make_mesh,
    partition_state_shardings,
    shard_batch,
    tp_shard_params,
)
from style_transfer_based_holographic_imaging_tpu_torch.parallel.zero import jax_dims
from style_transfer_based_holographic_imaging_tpu_torch.pipelines import RetrievalService, stream_retrieval
from style_transfer_based_holographic_imaging_tpu_torch.train import (
    create_train_state,
    latest_snapshot,
    load_train_params,
    train,
)

WORLD_TIMEOUT_S = 400.0
LOSS_RTOL = 2e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-6
SHARDED_LOSS, SHARDED_PARAMS = 1e-5, 2e-5
JAX_LEAF_TOL, JAX_STEP_LR = 1e-4, 0.1
MU_TOL = 1e-4
PH_FOC_ATOL = 2e-4
WORLD2 = ("dp", "dp_tv", "dp_accum_dropout", "dp_accum_noclip", "zero1", "fsdp", "fsdp_adv", "tp",
          "dp_clip", "fsdp_clip", "tp_clip")
WORLD4 = ("tp_fsdp",)
ONE_PROCESS = ("dp", "dp_tv", "dp_accum_dropout", "dp_accum_noclip", "fsdp_adv", "tp_fsdp", "fsdp_clip")
# What each sharded case is held to: the mesh's dp step, or the one-process step.
SHARDED = {"zero1": "dp", "fsdp": "dp", "fsdp_adv": "one", "tp": "one", "tp_fsdp": "one"}


def to_jax_tree(state):
    """A port state dict in the JAX package's layout, under ``'params'``."""
    tree = {}
    for name, t in state.items():
        *mods, leaf = name.split(".")
        a = t.detach().numpy()
        if leaf == "weight":
            if a.ndim == 4 and not mods[-1].startswith("up"):
                a = np.transpose(a, (2, 3, 1, 0))
            elif a.ndim == 2:
                a = a.T
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node["kernel" if leaf == "weight" else "bias"] = jnp.asarray(a)
    return {"params": tree}


@pytest.fixture(scope="module")
def inputs():
    bank = jsynth.golden_digit_bank(j_load_goldens(), size=32, subset=jsynth.GOLDEN_TRAIN_DIGITS)
    jdata = jsynth.DataConfig(batch_size=DATA.batch_size, image_size=IMAGE, digit_pad=DATA.digit_pad)
    batch = jax.device_get(jsynth.synth_batch(jax.random.key(5), jnp.asarray(bank), data=jdata,
                                              physics=JPhysics(), return_gt=True))
    return {
        "params": init_net_params(torch.Generator().manual_seed(0), width=WIDTH),
        "disc_params": init_params(PatchDiscriminator(**DISC), torch.Generator().manual_seed(1)),
        "batch": {k: np.asarray(v) for k, v in batch.items()},
        "bank": np.asarray(bank),
    }


@pytest.fixture(scope="module")
def train_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_train")
    return {"world": str(root / "world"), "one": str(root / "one")}


@pytest.fixture(scope="module")
def world2(inputs, train_dirs):
    mesh = make_mesh(devices=["cpu"] * 2)
    return launch(world_checks, mesh, inputs, WORLD2, train_dirs["world"],
                  timeout=WORLD_TIMEOUT_S, threads=1)


@pytest.fixture(scope="module")
def world4(inputs):
    mesh = make_mesh(devices=["cpu"] * 4)
    return launch(world_checks, mesh, inputs, WORLD4, timeout=WORLD_TIMEOUT_S, threads=1)


@pytest.fixture(scope="module")
def one_process(inputs):
    return {case: step_once(inputs, case)[:2] for case in ONE_PROCESS}


@pytest.fixture(scope="module")
def jax_mesh_steps(inputs):
    """(aux, params, first moments; port state dicts) of the JAX package's
    step on a 2-device mesh, for ``dp`` and ``dp_tv``."""
    out = {}
    for case in ("dp", "dp_tv"):
        cfg = JTrainConfig(**{**BASE_TRAIN, **CASES[case][3]})
        mesh = j_make_mesh(2)
        state = j_create(to_jax_tree(inputs["params"]), cfg)
        step = j_make_step(JNet(width=WIDTH), JPhysics(), cfg, mesh=mesh)
        new, aux = step(state, j_shard_batch(inputs["batch"], mesh), jax.random.key(1))
        out[case] = (jax.device_get(aux), convert_params(jax.device_get(new.params)),
                     _convert_adam(jax.device_get(new.opt_state), "cpu").mu)
    return out


def result(world2, world4, case, rank=0):
    return (world4 if case in WORLD4 else world2)[rank][case]


def rel(a, b) -> float:
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def max_diff(a: dict, b: dict) -> float:
    assert set(a) == set(b)
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in b)


def assert_moments_close(got: dict, want: dict, label: str):
    """Adam's first moments after one step, 0.1 times the (clipped)
    gradient: every leaf within MU_TOL of its max. Unlike the params after
    Adam's first step (about lr times the gradient's sign), they scale with
    the gradient, so a share or reduction that leaves every rank's gradient
    N times too large or too small fails here."""
    assert set(got) == set(want), label
    errs = {k: float((got[k].double() - w.double()).abs().max() / max(float(w.abs().max()), 1e-30))
            for k, w in want.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] < MU_TOL, (label, worst, errs[worst])


# --------------------------------------------------------------------------
# Steps on a mesh against the one-process step and the JAX package's
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["dp", "dp_tv", "dp_accum_dropout"])
def test_dp_step_loss_matches_one_process(case, world2, one_process):
    aux, _ = one_process[case]
    got = world2[0][case]["aux"]
    assert set(got) == set(aux)
    for k in aux:
        assert rel(got[k], aux[k]) < LOSS_RTOL, (k, got[k], aux[k])


@pytest.mark.parametrize("case", ["dp", "dp_tv", "dp_accum_dropout"])
def test_dp_step_params_match_one_process(case, world2, one_process):
    _, state = one_process[case]
    got = world2[0][case]["params"]
    for k, want in state.params.items():
        np.testing.assert_allclose(got[k].numpy(), want.numpy(), rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=k)
    assert_moments_close(world2[0][case]["mu"], state.opt_state.mu, case)


def test_accumulated_moments_match_one_process(world2, one_process):
    """``grad_accum`` 2 with dropout and without the clip: the moments of
    the micro-batches' summed shares are the one-process step's, so the
    accumulation's scale is right on the mesh."""
    aux, state = one_process["dp_accum_noclip"]
    got = world2[0]["dp_accum_noclip"]
    for k in aux:
        assert rel(got["aux"][k], aux[k]) < LOSS_RTOL, (k, got["aux"][k], aux[k])
    assert_moments_close(got["mu"], state.opt_state.mu, "dp_accum_noclip")


def test_tv_share_is_a_sum_not_a_mean(world2, one_process):
    """The TV term reaches the global loss whole: the logged ``loss_tv`` is
    the one-process sum, not its share, and with it the params move as the
    one-process step moves them, which averaging the ranks' local TV
    (a gradient N times too small) would not."""
    aux, state = one_process["dp_tv"]
    got = world2[0]["dp_tv"]
    assert rel(got["aux"]["loss_tv"], aux["loss_tv"]) < LOSS_RTOL
    plain = world2[0]["dp"]["params"]
    assert max_diff(got["params"], state.params) < max_diff(plain, state.params)


@pytest.mark.parametrize("case", ["dp", "dp_tv"])
def test_dp_step_matches_jax_mesh_step(case, world2, jax_mesh_steps):
    jaux, jparams, jmu = jax_mesh_steps[case]
    got = world2[0][case]
    assert rel(got["aux"]["loss_total"], jaux["loss_total"]) < LOSS_RTOL
    lr = train_config().lr
    bad = {}
    for k, want in jparams.items():
        excess = float(((got["params"][k].double() - want.double()).abs() - JAX_STEP_LR * lr).max()
                       / want.abs().max())
        if not excess < JAX_LEAF_TOL:
            bad[k] = excess
    assert not bad, bad
    assert_moments_close(got["mu"], jmu, case)


@pytest.mark.parametrize("case", ["dp_clip", "fsdp_clip", "tp_clip"])
def test_clip_takes_the_global_norm_over_the_shards(case, world2, one_process):
    """With the clip at 1e-3, far below the gradient's norm, the first
    moment is 0.1 times the clipped gradient: it equals the one-process
    step's only if every rank divides by the same global norm, each shard
    counted once (dp: every leaf whole on both ranks, counted once; fsdp:
    the data shards; tp: the model slices, with the leaves whole on both
    model ranks counted once)."""
    _, state = one_process["fsdp_clip"]
    got = world2[0][case]["mu"]
    for k, want in state.opt_state.mu.items():
        err = float((got[k].double() - want.double()).abs().max() / want.abs().max())
        assert err < 1e-4, (k, err)


@pytest.mark.parametrize("case", sorted(SHARDED))
def test_sharded_step_matches(case, world2, world4, one_process):
    """``zero1`` and ``fsdp`` against the mesh's ``dp`` step; ``tp``,
    ``tp_fsdp`` and the adversarial cases against the one-process step."""
    got = result(world2, world4, case)
    if SHARDED[case] == "dp":
        want_aux, want = world2[0]["dp"]["aux"], world2[0]["dp"]
        want = {k: want[k] for k in ("params", "ema", "disc", "mu", "disc_mu")}
    else:
        want_aux, state = one_process[case] if case in one_process else one_process["dp"]
        want = {"params": state.params, "ema": state.ema_params, "disc": state.disc_params,
                "mu": state.opt_state.mu,
                "disc_mu": None if state.disc_opt_state is None else state.disc_opt_state.mu}
    assert set(got["aux"]) == set(want_aux)
    for k in want_aux:
        assert abs(got["aux"][k] - want_aux[k]) < SHARDED_LOSS, k
    for group in ("params", "ema", "disc"):
        if want[group] is None:
            assert got[group] is None
        else:
            assert max_diff(got[group], want[group]) < SHARDED_PARAMS, group
    for group in ("mu", "disc_mu"):
        if want[group] is None:
            assert got[group] is None
        else:
            assert_moments_close(got[group], want[group], f"{case} {group}")


# The local shapes of decoder.conv0.weight (OIHW, (128, 128, 3, 3) at width
# 0.25) and its first moment on a rank: the layout each plan gives them.
LAYOUTS = {
    "dp": ((128, 128, 3, 3), (128, 128, 3, 3)),
    "zero1": ((128, 128, 3, 3), (128, 64, 3, 3)),      # moments: input channels over data
    "fsdp": ((128, 64, 3, 3), (128, 64, 3, 3)),
    "tp": ((64, 128, 3, 3), (64, 128, 3, 3)),          # output channels over model
    "tp_fsdp": ((64, 64, 3, 3), (64, 64, 3, 3)),       # both
}


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_shards_lie_as_the_plan_says(case, world2, world4):
    assert result(world2, world4, case)["shapes"] == {"params": LAYOUTS[case][0], "mu": LAYOUTS[case][1]}


@pytest.mark.parametrize("case", ["dp", "zero1", "fsdp", "tp", "tp_fsdp"])
def test_every_rank_ends_with_the_same_state(case, world2, world4):
    ranks = world4 if case in WORLD4 else world2
    for r in range(1, len(ranks)):
        assert max_diff(ranks[r][case]["params"], ranks[0][case]["params"]) == 0.0, r
        assert ranks[r][case]["aux"] == ranks[0][case]["aux"], r


# --------------------------------------------------------------------------
# The plans
# --------------------------------------------------------------------------


def port_and_jax_states(inputs):
    kw = dict(ema_decay=0.999, adv_weight=1.0, freeze_encoder=False)
    state = create_train_state(inputs["params"], train_config(**kw), disc_params=inputs["disc_params"],
                               device="cpu")
    jstate = j_create(to_jax_tree(inputs["params"]), JTrainConfig(**kw),
                      disc_params=to_jax_tree(inputs["disc_params"]))
    return state, jstate


def test_partition_plan_dispatch(inputs):
    state, _ = port_and_jax_states(inputs)
    mesh = make_mesh(devices=["cpu"] * 8)
    assert partition_state_shardings("dp", state, mesh) is None
    z = partition_state_shardings("zero1", state, mesh)
    assert z.params[LEAF].is_fully_replicated          # ZeRO-1 keeps params whole
    assert z.opt_state.mu[LEAF].spec == (None, DATA_AXIS, None, None)
    f = partition_state_shardings("fsdp", state, mesh)
    assert f.params[LEAF].spec == (None, DATA_AXIS, None, None)   # HWIO's I: OIHW's dim 1
    with pytest.raises(ValueError, match="model"):
        partition_state_shardings("tp", state, mesh)
    with pytest.raises(ValueError, match="unknown partition"):
        partition_state_shardings("megatron", state, mesh)
    mesh2 = make_mesh(devices=["cpu"] * 8, axis_names=(DATA_AXIS, MODEL_AXIS), shape=(2, 4))
    t = partition_state_shardings("tp_fsdp", state, mesh2)
    assert t.params[LEAF].spec == (MODEL_AXIS, DATA_AXIS, None, None)


def test_tp_shard_params_splits_output_channels(inputs):
    """Each rank's slice of a state dict: a conv's OIHW dim 0, a transposed
    conv's dim 1, the 3-channel stem (indivisible) whole."""
    params = inputs["params"]
    mesh = make_mesh(devices=["cpu"] * 2, axis_names=(DATA_AXIS, MODEL_AXIS), shape=(1, 2))
    parts = [tp_shard_params(params, mesh, r) for r in range(2)]
    assert torch.equal(torch.cat([p[LEAF] for p in parts], 0), params[LEAF])
    up = "decoder.up0.weight"
    assert torch.equal(torch.cat([p[up] for p in parts], 1), params[up])
    assert all(torch.equal(p["encoder.stem.weight"], params["encoder.stem.weight"]) for p in parts)


MESH_SHAPES = {"2": (2,), "4": (4,), "2x2": (2, 2)}


def _axes(plan, shape):
    if plan in ("tp", "tp_fsdp") and len(shape) == 1:
        return (DATA_AXIS, MODEL_AXIS), (1,) + shape
    return ((DATA_AXIS,) if len(shape) == 1 else (DATA_AXIS, MODEL_AXIS)), shape


@pytest.mark.parametrize("mesh_shape", sorted(MESH_SHAPES))
@pytest.mark.parametrize("plan", ["zero1", "fsdp", "tp", "tp_fsdp"])
def test_plans_split_the_jax_logical_dims(plan, mesh_shape, inputs):
    """Each port leaf is split on the dim that is, in the JAX layout, the dim
    the JAX package's plan splits, over the same axis: params, EMA,
    discriminator and both nets' Adam moments."""
    axes, shape = _axes(plan, MESH_SHAPES[mesh_shape])
    state, jstate = port_and_jax_states(inputs)
    port = partition_state_shardings(plan, state, make_mesh(devices=["cpu"] * int(np.prod(shape)),
                                                             axis_names=axes, shape=shape))
    jax_plan = j_partition(plan, jstate, j_make_mesh(int(np.prod(shape)), axis_names=axes, shape=shape))

    def pairs(jtree, jvalues):
        jtree, jvalues = jtree.get("params", jtree), jvalues.get("params", jvalues)
        specs = dict(_flatten_specs(jtree))
        shapes = dict((p, v.shape) for p, v in _flatten(jax.device_get(jvalues)))
        return {_convert_leaf(p, np.empty(shapes[p]))[0]: (tuple(specs[p].spec), len(shapes[p]))
                for p in shapes}

    groups = {
        "params": (jax_plan.params, jstate.params, port.params),
        "ema": (jax_plan.ema_params, jstate.ema_params, port.ema_params),
        "disc": (jax_plan.disc_params, jstate.disc_params, port.disc_params),
        "mu": (_adam_state(jax_plan.opt_state)[1], _adam_state(jstate.opt_state)[1], port.opt_state.mu),
        "disc_mu": (_adam_state(jax_plan.disc_opt_state)[1], _adam_state(jstate.disc_opt_state)[1],
                    port.disc_opt_state.mu),
    }
    split = 0
    for group, (jtree, jvalues, ptree) in groups.items():
        want = pairs(jtree, jvalues)
        assert set(want) == set(ptree), group
        for name, (jspec, ndim) in want.items():
            pspec = ptree[name].spec
            for j, p in enumerate(jax_dims(name, ndim)):
                j_axis = jspec[j] if j < len(jspec) else None
                p_axis = pspec[p] if pspec else None
                assert p_axis == j_axis, (group, name, jspec, pspec)
                split += j_axis is not None
    assert split > 0


def _flatten_specs(tree, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, dict):
            yield from _flatten_specs(value, path)
        else:
            yield path, value


# --------------------------------------------------------------------------
# train() on a mesh, the snapshots, the errors
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_process_run(inputs, train_dirs):
    cfg = run_config(train_dirs["one"], inputs["bank"])
    return train(cfg, bank=inputs["bank"], device="cpu", log_fn=lambda _: None)


def test_train_fsdp_matches_the_one_process_run(world2, one_process_run, train_dirs):
    """``train(partition="fsdp")`` on two ranks: two steps of the port's own
    stream (each rank renders its rows of the global batch) give the
    one-process run's params, and rank 0's log the one-process losses."""
    got = world2[0]["train"]
    assert got["step"] == one_process_run.step == 2
    assert max_diff(got["params"], one_process_run.params) < SHARDED_PARAMS
    rows = {name: [json.loads(line) for line in open(os.path.join(train_dirs[name], "train_metrics.jsonl"))]
            for name in ("world", "one")}
    assert [r["step"] for r in rows["world"]] == [1, 2]
    for a, b in zip(rows["world"], rows["one"]):
        for k in b:
            if k.startswith("loss_"):
                assert rel(a[k], b[k]) < LOSS_RTOL, k


def test_sharded_snapshot_restores_one_process(world2, train_dirs):
    """Rank 0's snapshots hold the whole state: they load as a one-process
    run's (``load_train_params``, ``latest_snapshot``) and match its own."""
    assert latest_snapshot(train_dirs["world"]).endswith("iter_2")
    for it in (1, 2):
        got = load_train_params(os.path.join(train_dirs["world"], f"iter_{it}"), ema=False)
        want = load_train_params(os.path.join(train_dirs["one"], f"iter_{it}"), ema=False)
        assert max_diff(got, want) < SHARDED_PARAMS, it


def test_sharded_snapshot_restores_into_another_partition(world2):
    """The fsdp run's first snapshot sharded under ``zero1`` and gathered back
    is itself, bit for bit, and one ``zero1`` step from it gives the fsdp
    run's second step."""
    got = world2[0]["train"]
    assert got["round_trip"] == 0.0
    assert got["resumed_step"] == 2
    assert max_diff(got["resumed"], got["params"]) < SHARDED_PARAMS


def test_train_mesh_errors(inputs, tmp_path):
    cfg = run_config(str(tmp_path), inputs["bank"])
    with pytest.raises(ValueError, match="requires a mesh"):
        train(cfg, bank=inputs["bank"], partition="zero1", device="cpu")
    bad = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, batch_size=6))
    with pytest.raises(ValueError, match="divisible by"):
        train(bad, bank=inputs["bank"], mesh=make_mesh(devices=["cpu"] * 4), device="cpu")
    with pytest.raises(ValueError, match="data-parallel axis"):
        train(cfg, bank=inputs["bank"], mesh=make_mesh(devices=["cpu"] * 2, axis_names=(MODEL_AXIS,)),
              device="cpu")


def test_make_mesh_and_shard_batch():
    with pytest.raises(ValueError, match="only 2 devices"):
        make_mesh(3, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="shape required"):
        make_mesh(devices=["cpu"] * 4, axis_names=(DATA_AXIS, MODEL_AXIS))
    mesh = make_mesh(devices=["cpu"] * 8, axis_names=(DATA_AXIS, MODEL_AXIS), shape=(2, 2))
    assert mesh.size == 4 and dict(mesh.shape) == {DATA_AXIS: 2, MODEL_AXIS: 2}
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    parts = shard_batch({"x": x, "w": np.float32(2.0)}, mesh)
    assert [p["x"][:, 0].tolist() for p in parts] == [[0, 3, 6, 9]] * 2 + [[12, 15, 18, 21]] * 2
    assert all(p["w"].ndim == 0 and float(p["w"]) == 2.0 for p in parts)
    assert batch_sharding(mesh).shard_shape(x.shape) == (4, 3)


# --------------------------------------------------------------------------
# Serving and streaming over a mesh
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def served():
    from torch_seeded import seeded_net, seeded_params, seeded_style

    width = WIDTH
    net = seeded_net(seeded_params(width, 128), width)
    style = seeded_style(net.encoder.out_channels)
    cfg = ExperimentConfig(model=ModelConfig(width=width))
    g = load_golden_suite()
    holo = g.content_holo.reshape(-1, 1, 128, 128)[:8]
    return net, style, cfg, holo


def test_dp_serving_matches_one_device(served):
    net, style, cfg, holo = served
    one = RetrievalService(net, style, cfg, batch_size=8, device="cpu").retrieve(holo)
    mesh = make_mesh(devices=["cpu"] * 2)
    service = RetrievalService(net, style, cfg, batch_size=8, mesh=mesh)
    got = service.retrieve(holo[:5])      # padded to 8, split 4 + 4, trimmed
    assert service.health()["n_devices"] == 2
    assert got["ph_foc"].shape == (5, 1, 128, 128)
    np.testing.assert_allclose(got["ph_foc"], one["ph_foc"][:5], atol=PH_FOC_ATOL)
    np.testing.assert_allclose(got["distance_pred"], one["distance_pred"][:5], atol=1e-6)


def test_dp_serving_errors(served):
    net, style, cfg, _ = served
    with pytest.raises(ValueError, match="lack the batch axis"):
        RetrievalService(net, style, cfg, batch_size=8,
                         mesh=make_mesh(devices=["cpu"] * 2, axis_names=(MODEL_AXIS,)))
    with pytest.raises(ValueError, match="must be divisible"):
        RetrievalService(net, style, cfg, batch_size=5, mesh=make_mesh(devices=["cpu"] * 2))


def test_dp_streaming_matches_one_device(served):
    net, style, cfg, holo = served
    batches = [{"holo": holo[:4]}, {"holo": holo[4:7]}]          # the last one padded
    one = list(stream_retrieval(net, batches, style, cfg, device="cpu"))
    got = list(stream_retrieval(net, batches, style, cfg, device="cpu",
                                sharding=batch_sharding(make_mesh(devices=["cpu"] * 2))))
    assert [o["ph_foc"].shape[0] for o in got] == [4, 3]
    for a, b in zip(got, one):
        np.testing.assert_allclose(a["ph_foc"].numpy(), b["ph_foc"].numpy(), atol=PH_FOC_ATOL)
    with pytest.raises(ValueError, match="must divide"):
        list(stream_retrieval(net, [{"holo": holo[:3]}], style, cfg, device="cpu",
                              sharding=batch_sharding(make_mesh(devices=["cpu"] * 2))))
