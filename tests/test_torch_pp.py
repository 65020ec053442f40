"""The port's GPipe pipeline (``parallel/pp.py``) in spawned ``gloo``
worlds on the CPU (``tests/torch_pp_world.py``: one 2-rank world and one
4-rank world, shared with ``tests/test_torch_fft_sharding.py``), against
the JAX package's single-device references and the port's one-process
gradients.

Width 0.25, 32^2, the seed-0 ``init_net_params`` state dict (and one with
``decoder_ph``), carried to the JAX package by layout (``jax_tree``).

* ``pipeline_plan`` equals the JAX package's name for name.
* Retrieval on 2 and 4 stages, with and without ``decoder_ph``, B = 8,
  ``n_micro`` 4, against the JAX package's single-device
  ``retrieval_step``: ``tests/test_parallel.py``'s tolerances, 1e-5 for
  the fields, the distance and ``amp_foc``, 2e-3 for ``ph_foc``.
* The fine-tune (B = 4, ``n_micro`` 2): its first loss within 5e-4
  relative of the JAX package's single-device objective (the JAX test's
  rule); its whole gradient, the stages' gradients joined, within 1e-4 of
  each leaf's max of the port's one-process gradient of the same objective
  (a gradient S times too large reads S - 1 times the leaf's max); the
  loss lower after 4 steps.
* A full training step, without and with the adversarial term: each loss
  term within 1e-4 + 1e-4 |ref| of the JAX package's jitted
  ``generator_loss_fn`` (the JAX test's rule), the whole gradient within
  1e-4 of each leaf's max of the port's one-process ``generator_loss_fn``
  gradient; with the adversarial term the replicated discriminator moves.
* A JAX pipeline state (``_pack_stage_params``' packed array, with moments
  and a count) converts to one state a stage and back bit for bit, and the
  converted stage params are each rank's own, bit for bit.

The port against the JAX package's own ``make_pipeline_*`` (a shard_map
program that compiles for about a minute) is the ``slow`` test.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_cpu_threads import warm_few_torch_threads  # noqa: F401
from torch_pp_world import (
    D_STYLE,
    DISC,
    FINETUNE_LR,
    IMAGE,
    N_MICRO,
    TRAIN_CFG,
    TRAIN_LR,
    WIDTH,
    inputs,
    jax_tree,
    stage_grads,
    train_config,
    world,
)

from style_transfer_based_holographic_imaging_tpu.config import PhysicsConfig as JPhysics
from style_transfer_based_holographic_imaging_tpu.config import TrainConfig as JTrainConfig
from style_transfer_based_holographic_imaging_tpu.models import PatchDiscriminator as JDisc
from style_transfer_based_holographic_imaging_tpu.models import StyleTransferNet as JNet
from style_transfer_based_holographic_imaging_tpu.ops import holo_forward as j_holo_forward
from style_transfer_based_holographic_imaging_tpu.parallel import pp as jpp
from style_transfer_based_holographic_imaging_tpu.pipelines import retrieval_step as j_retrieval_step
from style_transfer_based_holographic_imaging_tpu.train.loop import generator_loss_fn as j_generator_loss_fn
from style_transfer_based_holographic_imaging_tpu_torch.config import PhysicsConfig
from style_transfer_based_holographic_imaging_tpu_torch.interop import (
    convert_pipeline_state,
    pipeline_state_to_jax,
)
from style_transfer_based_holographic_imaging_tpu_torch.models import PatchDiscriminator, StyleTransferNet
from style_transfer_based_holographic_imaging_tpu_torch.models.net import style_stats_nchw
from style_transfer_based_holographic_imaging_tpu_torch.parallel import make_mesh, make_pipeline_train_fn, pipeline_plan
from style_transfer_based_holographic_imaging_tpu_torch.parallel.pp import stage_leaves
from style_transfer_based_holographic_imaging_tpu_torch.train.loop import generator_loss_fn
from style_transfer_based_holographic_imaging_tpu_torch.train.losses import distance_loss, style_plane_target

RETRIEVAL_TOL = {"amp_field": 1e-5, "ph_field": 1e-5, "distance_pred": 1e-5, "amp_foc": 1e-5, "ph_foc": 2e-3}
FINETUNE_LOSS_RTOL = 5e-4
LEAF_TOL = 1e-4
AUX_TOL = 1e-4
TRAIN_KEYS = ("loss_content", "loss_style", "loss_physics", "loss_distance", "loss_supervised", "loss_total")


def leaf_share(got, want):
    """The worst leaf's max |got - want| over its max |want|, in units of LEAF_TOL."""
    return max(float((got[k] - w).abs().max()) / max(float(w.abs().max()), 1e-30) for k, w in want.items()) \
        / LEAF_TOL


@pytest.mark.parametrize("image, stages, width, ph", [
    (64, 4, 1.0, False), (64, 4, 1.0, True), (32, 2, 1.0, False), (32, 2, 1.0, True),
    (32, 8, 1.0, False), (32, 8, 1.0, True), (64, 4, 0.5, False), (32, 3, 0.5, True)])
def test_pipeline_plan_matches_jax(image, stages, width, ph):
    assert pipeline_plan(image, stages, width, ph) == jpp.pipeline_plan(image, stages, width, ph)


# ---- retrieval ----


def jax_retrieval_step(params, holo, sm, ss, ph=False):
    """The JAX package's single-device ``retrieval_step`` at D_STYLE, jitted
    (one compile; eager, each op compiles: ten times longer)."""
    fn = jax.jit(functools.partial(j_retrieval_step, physics=JPhysics(),
                                   net=JNet(width=WIDTH, with_phase_decoder=ph)), static_argnums=(4,))
    out = fn(jax_tree(params), jnp.asarray(holo), jnp.asarray(sm), jnp.asarray(ss), D_STYLE)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def jax_retrieval():
    inp = inputs()
    return {name: jax_retrieval_step(inp[key], inp["holo"], inp["sm"], inp["ss"], name.endswith("_ph"))
            for name, key in (("retrieval", "params"), ("retrieval_ph", "params_ph"))}


@pytest.mark.parametrize("key", list(RETRIEVAL_TOL))
@pytest.mark.parametrize("name", ["retrieval", "retrieval_ph"])
@pytest.mark.parametrize("n", [2, 4])
def test_retrieval_matches_jax(n, name, key, jax_retrieval):
    want = jax_retrieval[name][key]
    for r in world(n):
        np.testing.assert_allclose(r[name]["out"][key].numpy(), want, atol=RETRIEVAL_TOL[key], rtol=0)


@pytest.mark.parametrize("n", [2, 4])
def test_retrieval_raises_on_an_indivisible_batch(n):
    assert all(r["retrieval"]["raises"] for r in world(n))


@pytest.mark.parametrize("name", ["retrieval", "retrieval_ph"])
@pytest.mark.parametrize("n", [2, 4])
def test_each_rank_holds_its_stage_alone(n, name):
    inp = inputs()
    whole = inp["params_ph" if name.endswith("_ph") else "params"]
    ranks = world(n)
    assert ranks[0][name]["stages"] == pipeline_plan(IMAGE, n, WIDTH, name.endswith("_ph"))
    held = [set(r[name]["stage_params"]) for r in ranks]
    assert sum(len(h) for h in held) == len(whole) and set().union(*held) == set(whole)
    for r, stage in zip(ranks, ranks[0][name]["stages"]):
        prefixes = tuple(layer.replace("/", ".") + "." for layer in stage)
        assert all(k.startswith(prefixes) and torch.equal(v, whole[k]) for k, v in r[name]["stage_params"].items())


# ---- the fine-tune ----


def finetune_inputs():
    inp = inputs()
    sm = inp["ft_sm"]
    return inp, sm, sm + 0.5


def test_finetune_first_loss_matches_jax():
    inp, sm, ss = finetune_inputs()
    b = {k: jnp.asarray(v) for k, v in inp["batch"].items()}
    phys = JPhysics()
    out = jax_retrieval_step(inp["params"], b["content_holo"] ** 2, sm, ss)
    gt_amp, gt_ph = jax.jit(lambda a, p, d: j_holo_forward(a, p, d, phys, return_field=True, asm_backend="xla"))(
        b["amplitude"], b["phase_content"], b["distance_style"])
    ref = (float(jnp.mean((out["amp_field"] - gt_amp) ** 2))
           + float(jnp.mean((out["ph_field"] - gt_ph / phys.phase_normalize) ** 2))
           + 10.0 * float(jnp.mean((out["distance_pred"].reshape(-1) - b["distance_content"].reshape(-1)) ** 2)))
    for r in world(2):
        assert abs(r["finetune"]["loss"] - ref) < FINETUNE_LOSS_RTOL * max(1.0, abs(ref))


@pytest.fixture(scope="module")
def finetune_one_process():
    """The fine-tune's objective on the whole net in one process, and its gradient."""
    inp, sm, ss = finetune_inputs()
    net = StyleTransferNet(width=WIDTH)
    net.load_state_dict(inp["params"])
    b = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    phys = PhysicsConfig()
    amp, ph, d = net.field_retrieval(b["content_holo"], style_stats_nchw(torch.from_numpy(sm)),
                                     style_stats_nchw(torch.from_numpy(ss)), unknown_distance=True)
    gt_amp, gt_ph = style_plane_target(b["amplitude"], b["phase_content"], b["distance_style"], phys)
    loss = (torch.mean((amp - gt_amp) ** 2) + torch.mean((ph - gt_ph / phys.phase_normalize) ** 2)
            + 10.0 * distance_loss(d, b["distance_content"]))
    names, params = zip(*net.named_parameters())
    return float(loss.detach()), dict(zip(names, torch.autograd.grad(loss, params)))


@pytest.mark.parametrize("n", [2, 4])
def test_finetune_loss_is_the_one_process_loss(n, finetune_one_process):
    loss, _ = finetune_one_process
    assert all(abs(r["finetune"]["loss"] - loss) < 1e-6 * abs(loss) for r in world(n))


@pytest.mark.parametrize("n", [2, 4])
def test_finetune_gradient_is_the_one_process_gradient(n, finetune_one_process):
    _, want = finetune_one_process
    got = stage_grads(world(n), "finetune")
    assert set(got) == set(want)
    assert leaf_share(got, want) < 1.0


@pytest.mark.parametrize("n", [2, 4])
def test_the_gradient_rule_refuses_a_gradient_scaled_by_the_stages(n, finetune_one_process):
    _, want = finetune_one_process
    scaled = {k: n * v for k, v in stage_grads(world(n), "finetune").items()}
    assert leaf_share(scaled, want) > 1.0


@pytest.mark.parametrize("n", [2, 4])
def test_finetune_loss_falls(n):
    for r in world(n):
        losses = r["finetune"]["losses"]
        assert losses[-1] < losses[0] and r["finetune"]["t"] == len(losses)


# ---- full training ----


@pytest.fixture(scope="module")
def jax_train_aux():
    inp = inputs()
    b = {k: jnp.asarray(v) for k, v in inp["batch"].items()}
    out = {}
    for name, adv in (("train", False), ("train_adv", True)):
        cfg = JTrainConfig(**{**TRAIN_CFG, "adv_weight": train_config(adv).adv_weight})
        kw = dict(net=JNet(width=WIDTH), physics=JPhysics(), cfg=cfg)
        if adv:
            kw.update(disc=JDisc(**DISC), disc_params=jax_tree(inp["disc_params"]))
        _, aux = jax.jit(functools.partial(j_generator_loss_fn, **kw))(jax_tree(inp["params"]), b,
                                                                       jax.random.key(1))
        out[name] = {k: float(v) for k, v in jax.device_get(aux).items() if k.startswith("loss_")}
    return out


@pytest.mark.parametrize("key", TRAIN_KEYS + ("loss_adv",))
@pytest.mark.parametrize("name", ["train", "train_adv"])
def test_train_loss_matches_the_jax_dp_loss(name, key, jax_train_aux):
    if key == "loss_adv" and name == "train":
        assert key not in world(2)[0][name]["aux"]
        return
    ref = jax_train_aux[name][key]
    for r in world(2):
        got = r[name]["aux"][key]
        assert abs(got - ref) < AUX_TOL + AUX_TOL * abs(ref), (got, ref)


@pytest.fixture(scope="module")
def train_one_process():
    inp = inputs()
    b = {k: torch.from_numpy(v) for k, v in inp["batch"].items()}
    out = {}
    for name, adv in (("train", False), ("train_adv", True)):
        params = {k: v.clone().requires_grad_(True) for k, v in inp["params"].items()}
        kw = dict(disc=PatchDiscriminator(**DISC), disc_params=inp["disc_params"]) if adv else {}
        loss, _ = generator_loss_fn(params, b, net=StyleTransferNet(width=WIDTH), physics=PhysicsConfig(),
                                    cfg=train_config(adv), **kw)
        out[name] = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    return out


@pytest.mark.parametrize("name", ["train", "train_adv"])
def test_train_gradient_is_the_one_process_gradient(name, train_one_process):
    want = train_one_process[name]
    got = stage_grads(world(2), name)
    assert set(got) == set(want)
    assert leaf_share(got, want) < 1.0


def test_train_step_moves_the_replicated_discriminator():
    ranks = world(2)
    assert all(r["train_adv"]["disc_moved"] > 0.0 for r in ranks)
    assert all(np.isfinite(r["train_adv"]["aux"]["loss_disc"]) for r in ranks)
    assert "loss_disc" not in ranks[0]["train"]["aux"]


def test_train_refuses_the_perceptual_term():
    mesh = make_mesh(devices=["cpu"] * 2, axis_names=("pipe",))
    cfg = dataclasses.replace(train_config(), perceptual_weight=1.0)
    with pytest.raises(ValueError, match="perceptual_weight"):
        make_pipeline_train_fn(inputs()["params"], mesh, n_micro=N_MICRO, image_size=IMAGE,
                               physics=PhysicsConfig(), cfg=cfg, width=WIDTH)


# ---- the JAX pipeline state ----


@functools.lru_cache(maxsize=None)
def jax_packed_state(n, ph):
    """The JAX package's packed (S, Pmax) params of the seed-0 net (its
    ``_pack_stage_params``, jitted: one compile), with moments and a count
    of distinct values."""
    inp = inputs()
    tree = jax_tree(inp["params_ph" if ph else "params"])
    stages = jpp._partition(jpp._build_chain(IMAGE, WIDTH, ph), n)
    packed = np.asarray(jax.jit(lambda t: jpp._pack_stage_params(t, stages, WIDTH)[0])(tree))
    rng = np.random.default_rng(n)
    m = rng.normal(size=packed.shape).astype(np.float32)
    v = rng.random(packed.shape, dtype=np.float32)
    return packed, m, v, np.float32(3.0)


@pytest.mark.parametrize("ph", [False, True])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_jax_pipeline_state_round_trips(n, ph):
    packed, m, v, t = (np.copy(a) for a in jax_packed_state(n, ph))
    kw = dict(image_size=IMAGE, width=WIDTH, n_stages=n, with_phase_decoder=ph)
    # the pack's padding beyond a stage's leaves is not state: the moments
    # of a JAX step are zero there, as the packed params are
    sizes = [sum(int(np.prod(s)) for _, s in leaves) for leaves in stage_leaves(IMAGE, WIDTH, n, ph)]
    for s, size in enumerate(sizes):
        m[s, size:] = 0.0
        v[s, size:] = 0.0
    back = pipeline_state_to_jax(convert_pipeline_state(packed, m, v, t, **kw), **kw)
    assert all(np.array_equal(a, b) for a, b in zip(back[:3], (packed, m, v))) and back[3] == t


@pytest.mark.parametrize("name", ["retrieval", "retrieval_ph"])
@pytest.mark.parametrize("n", [2, 4])
def test_converted_jax_state_is_each_ranks_stage(n, name):
    ph = name.endswith("_ph")
    packed, m, v, t = jax_packed_state(n, ph)
    states = convert_pipeline_state(packed, m, v, t, image_size=IMAGE, width=WIDTH, n_stages=n,
                                    with_phase_decoder=ph)
    for state, r in zip(states, world(n)):
        mine = r[name]["stage_params"]
        assert set(state[0]) == set(mine) and all(torch.equal(state[0][k], mine[k]) for k in mine)


# ---- against the JAX package's own pipeline ----


@pytest.mark.slow
def test_port_matches_the_jax_pipeline():
    """The 2-rank world against the JAX package's ``make_pipeline_*`` on a
    2-device ``pipe`` mesh: the retrieval (the same tolerances), the
    fine-tune's first loss and its params after 4 steps, the full train
    step's loss terms (within 1e-4 + 1e-4 |ref|). Compiles JAX's shard_map
    programs: about a minute."""
    from jax.sharding import Mesh

    inp, sm, ss = finetune_inputs()
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("pipe",))
    ranks = world(2)
    fn = jpp.make_pipeline_retrieval_fn(jax_tree(inp["params"]), mesh, n_micro=4, image_size=IMAGE,
                                        physics=JPhysics(), width=WIDTH)
    out = {k: np.asarray(v) for k, v in fn(jnp.asarray(inp["holo"]), jnp.asarray(inp["sm"]),
                                           jnp.asarray(inp["ss"]), D_STYLE).items()}
    for key, tol in RETRIEVAL_TOL.items():
        np.testing.assert_allclose(ranks[0]["retrieval"]["out"][key].numpy(), out[key], atol=tol, rtol=0)

    b = {k: jnp.asarray(v) for k, v in inp["batch"].items()}
    step, state = jpp.make_pipeline_finetune_fn(jax_tree(inp["params"]), mesh, n_micro=N_MICRO,
                                                image_size=IMAGE, physics=JPhysics(), lr=FINETUNE_LR,
                                                width=WIDTH)
    losses = []
    for _ in range(len(ranks[0]["finetune"]["losses"])):
        state, aux = step(state, b, jnp.asarray(sm), jnp.asarray(ss))
        losses.append(float(aux["loss_total"]))
    np.testing.assert_allclose(ranks[0]["finetune"]["losses"], losses, rtol=FINETUNE_LOSS_RTOL)

    cfg = JTrainConfig(**TRAIN_CFG)
    tstep, tstate = jpp.make_pipeline_train_fn(jax_tree(inp["params"]), mesh, n_micro=N_MICRO,
                                               image_size=IMAGE, physics=JPhysics(), cfg=cfg, lr=TRAIN_LR,
                                               width=WIDTH)
    _, taux = tstep(tstate, b)
    for key in TRAIN_KEYS:
        ref = float(taux[key])
        assert abs(ranks[0]["train"]["aux"][key] - ref) < AUX_TOL + AUX_TOL * abs(ref), key
