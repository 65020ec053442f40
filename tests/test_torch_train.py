"""Training on the port against the JAX package's ``train/`` on the CPU.

Width 0.25, 64^2 (the golden train-split digits at 32^2, padded by 16),
B = 2, the flagship's loss weights from ``checkpoints/config.json``
(adversarial 1.0, EMA 0.999, clip 1.0, supervised 10, physics 10, distance
20, rotate 20, elastic 2.5, the encoder trained). The same params (the
port's ``init_net_params``, carried to the JAX layout) and the same batches
(the JAX package's ``synth_batch``) go through both packages. Tolerances:

* losses and ``aux`` terms: 1e-5 relative (fp32 sums in other orders);
* activations: 1e-4 of the leaf's max |.|;
* ``generator_loss_fn``: the loss, its ``aux`` terms (1e-5 relative) and
  every gradient leaf (1e-4 of its max) against the JAX package's
  ``jax.value_and_grad`` of the same loss in float64 (under
  ``jax.enable_x64``, net and discriminator in float64; the physics and the
  loss sums stay fp32 as the package writes them): the port's fp32 values
  read up to 8.3e-7 and 5.9e-5 off. The JAX package's fp32 gradients are
  no anchor: XLA's fp32 weight gradients of the early encoder layers on
  hologram inputs (a large mean, small ripples) read up to 2.5e-3 of max
  off the float64 values. The fp32 JAX loss is held by the full steps'
  first ``aux``;
* the optimizer alone (clip, Adam, schedules, frozen encoder, EMA, the
  discriminator's Adam) given the JAX package's own gradients: 1e-6 of each
  leaf's max, the optax result;
* params, EMA and discriminator after three full steps (Adam, clip,
  invtime, EMA, discriminator), after ``grad_accum`` 2 under a frozen
  encoder and the cosine schedule, and after a resume from
  ``convert_train_state``: 1e-4 of each leaf's max, plus 0.1 lr for each
  step taken. Adam maps a rounding-level gradient difference in an element
  whose gradient is near its eps (1e-8) to a step difference of the order
  of lr, and the biases start at zero, so their max after n steps is about
  n lr: no relative bound alone holds there. The JAX package holds two
  equal Adam updates to 0.05 lr (``tests/test_train.py``, grad_accum
  against the full batch, atol 5e-6 at lr 1e-4); the worst element here
  reads 0.059 lr a step.

The JAX references are computed once per module (``jit``).
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_cpu_threads import warm_torch_threads  # noqa: F401

from style_transfer_based_holographic_imaging_tpu.config import ExperimentConfig as JConfig
from style_transfer_based_holographic_imaging_tpu.data import load_golden_suite as j_load_goldens
from style_transfer_based_holographic_imaging_tpu.data import synth as jsynth
from style_transfer_based_holographic_imaging_tpu.models import PatchDiscriminator as JDisc
from style_transfer_based_holographic_imaging_tpu.models import StyleTransferNet as JNet
from style_transfer_based_holographic_imaging_tpu.train import losses as jlosses
from style_transfer_based_holographic_imaging_tpu.train.loop import generator_loss_fn as j_loss_fn
from style_transfer_based_holographic_imaging_tpu.train.loop import make_train_step as j_make_step
from style_transfer_based_holographic_imaging_tpu.train.state import create_train_state as j_create
from style_transfer_based_holographic_imaging_tpu_torch import ExperimentConfig, cli
from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite, synth
from style_transfer_based_holographic_imaging_tpu_torch.interop import convert_params, convert_train_state
from style_transfer_based_holographic_imaging_tpu_torch.kernels import reflect_border
from style_transfer_based_holographic_imaging_tpu_torch.models import (
    PatchDiscriminator,
    ReflectConv,
    StyleTransferNet,
    init_net_params,
    init_params,
    set_reflect_backend,
)
from style_transfer_based_holographic_imaging_tpu_torch.train import (
    TrainStep,
    create_train_state,
    generator_loss_fn,
    latest_snapshot,
    load_train_params,
    losses,
    restore_checkpoint,
    save_checkpoint,
    train,
)
from style_transfer_based_holographic_imaging_tpu_torch.train.state import (
    apply_disc_gradients,
    apply_gradients,
    make_disc_optimizer,
    make_optimizer,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "checkpoints", "config.json")) as _f:
    CONFIG_TEXT = _f.read()
SMALL_MODEL = dict(width=0.25)
SMALL_DATA = dict(batch_size=2, image_size=64, digit_pad=16)
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-4
OPT_TOL = 1e-6
STEP_LR_TOL = 0.1   # of lr, for each step taken
N_STEPS = 3


def configs(**train_kw):
    """(JAX config, port config) of the flagship at the tests' size."""
    out = []
    for cls in (JConfig, ExperimentConfig):
        c = cls.from_json(CONFIG_TEXT)
        out.append(dataclasses.replace(
            c, model=dataclasses.replace(c.model, **SMALL_MODEL),
            data=dataclasses.replace(c.data, **SMALL_DATA),
            train=dataclasses.replace(c.train, **train_kw)))
    return out


def to_jax_tree(state):
    """A port state dict in the JAX package's layout (the inverse of
    ``convert_params``), under ``'params'``."""
    tree = {}
    for name, t in state.items():
        *mods, leaf = name.split(".")
        a = t.detach().numpy()
        if leaf == "weight":
            if a.ndim == 4 and not mods[-1].startswith("up"):
                a = np.transpose(a, (2, 3, 1, 0))        # OIHW -> HWIO
            elif a.ndim == 2:
                a = a.T
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node["kernel" if leaf == "weight" else "bias"] = jnp.asarray(a)
    return {"params": tree}


def rel(got, want) -> float:
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def assert_leaves_close(got: dict, want_tree, label: str, tol: float = LEAF_TOL, atol: float = 0.0):
    """Every leaf of ``got`` within ``tol`` of the leaf's max |.| plus
    ``atol`` of the JAX tree ``want_tree`` (or a port state dict)."""
    want = want_tree if isinstance(want_tree, dict) and all(
        isinstance(v, torch.Tensor) for v in want_tree.values()) else convert_params(jax.device_get(want_tree))
    assert set(got) == set(want), label
    bad = {}
    for k in want:
        w = want[k].double()
        excess = float(((got[k].double() - w).abs() - atol).max() / max(float(w.abs().max()), 1e-30))
        if not excess < tol:
            bad[k] = excess
    assert not bad, f"{label}: {len(bad)} leaves off, worst {sorted(bad.items(), key=lambda kv: -kv[1])[:5]}"


def nchw(x):
    return np.transpose(np.asarray(x), (0, 3, 1, 2))


def jax_batch_to_torch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = configs()
    bank = jsynth.golden_digit_bank(j_load_goldens(), size=32, subset=jsynth.GOLDEN_TRAIN_DIGITS)
    jbatches = [jax.device_get(jsynth.synth_batch(jax.random.fold_in(jax.random.key(0), i),
                                                  jnp.asarray(bank), data=jcfg.data,
                                                  physics=jcfg.physics, return_gt=True))
                for i in range(N_STEPS)]
    params = init_net_params(torch.Generator().manual_seed(0), width=0.25)
    disc = PatchDiscriminator(image_size=64)
    disc_params = init_params(disc, torch.Generator().manual_seed(1))
    net = StyleTransferNet(width=0.25)
    net.load_state_dict(params)
    disc.load_state_dict(disc_params)
    return dict(jcfg=jcfg, cfg=cfg, jbatches=jbatches, batches=[jax_batch_to_torch(b) for b in jbatches],
                params=params, disc_params=disc_params, net=net, disc=disc,
                jnet=JNet(width=0.25), jdisc=JDisc(image_size=64),
                jparams=to_jax_tree(params), jdisc_params=to_jax_tree(disc_params))


# --------------------------------------------------------------------------
# Initialization
# --------------------------------------------------------------------------


def test_init_net_params_has_the_jax_tree_and_the_flax_distributions(setup):
    """Names and shapes of ``init_net_params`` and of the discriminator's
    ``init_params`` are those of the JAX package's ``init`` (traced with
    ``eval_shape``); biases are zero, kernels a truncated normal (|w| < 2
    sigma of the untruncated normal) of variance 1/fan_in, fan_in of the JAX
    layout (the transposed convs' (C_in, C_out, 2, 2): 2 C_in C_out)."""
    d = jnp.ones((1, 64, 64, 1))
    shapes = jax.eval_shape(lambda k: JNet(width=0.25).init(
        k, d, d, field_retrieval=True, unknown_distance=True), jax.random.key(0))
    dshapes = jax.eval_shape(lambda k: JDisc(image_size=64).init(k, d), jax.random.key(0))
    for jtree, state in ((shapes, setup["params"]), (dshapes, setup["disc_params"])):
        want = convert_params(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), jtree))
        assert {k: tuple(v.shape) for k, v in state.items()} == {k: tuple(v.shape) for k, v in want.items()}
        for name, t in state.items():
            if name.endswith("bias"):
                assert not t.any(), name
                continue
            if name.split(".")[-2].startswith("up"):
                fan_in = 2 * t.shape[0] * t.shape[1]
            elif t.ndim == 2:
                fan_in = t.shape[1]
            else:
                fan_in = t.shape[1] * t.shape[2] * t.shape[3]
            sigma = 1.0 / np.sqrt(fan_in)
            assert float(t.abs().max()) <= 2.0 * sigma / 0.87962566103423978 * (1 + 1e-6), name
            if t.numel() >= 4000:       # std of the estimate about 1.1 %
                assert abs(float(t.std()) / sigma - 1.0) < 0.06, name


# --------------------------------------------------------------------------
# The training forward, the discriminator, the losses
# --------------------------------------------------------------------------


def test_training_forward_matches_jax(setup):
    b = setup["jbatches"][0]
    want = jax.jit(lambda p, c, s: setup["jnet"].apply(p, c, s, 1.0, field_retrieval=True,
                                                       unknown_distance=True))(
        setup["jparams"], jnp.asarray(b["content_holo"]).transpose(0, 2, 3, 1),
        jnp.asarray(b["style_holo"]).transpose(0, 2, 3, 1))
    tb = setup["batches"][0]
    with torch.no_grad():
        got = setup["net"](tb["content_holo"], tb["style_holo"])
    for k in ("loss_content", "loss_style"):
        assert rel(got[k], want[k]) < LOSS_RTOL, k
    assert set(got) == set(want) - {"style_re"}
    for k in ("g_t", "g_t_phase", "t"):
        assert rel(got[k], nchw(want[k])) < LEAF_TOL, k
    for k in ("d_content", "d_style"):
        assert rel(got[k], want[k]) < LEAF_TOL, k


def test_discriminator_matches_jax(setup):
    x = setup["batches"][0]["style_holo"]
    src, cls = jax.jit(setup["jdisc"].apply)(setup["jdisc_params"], jnp.asarray(x.numpy()).transpose(0, 2, 3, 1))
    with torch.no_grad():
        got_src, got_cls = setup["disc"](x)
    assert rel(got_src, nchw(src)) < LEAF_TOL
    assert rel(got_cls, cls) < LEAF_TOL


def _loss_cases():
    rng = np.random.default_rng(5)
    img = rng.normal(size=(2, 1, 16, 12)).astype(np.float32)
    logits = rng.normal(size=(2, 1, 2, 2)).astype(np.float32), rng.normal(size=(2, 1, 2, 2)).astype(np.float32)
    d = rng.random((2, 1)).astype(np.float32), rng.random((2, 1, 1, 1)).astype(np.float32)
    return {
        "tv_order1": (lambda m: m.tv_loss, (img,), {}),
        "tv_order2_norm": (lambda m: m.tv_loss, (img,), {"norm": True, "order": 2}),
        "tv_order3": (lambda m: m.tv_loss, (img,), {"order": 3}),
        "lsgan_d": (lambda m: m.lsgan_d_loss, logits, {}),
        "lsgan_g": (lambda m: m.lsgan_g_loss, logits[:1], {}),
        "distance": (lambda m: m.distance_loss, d, {}),
    }


@pytest.mark.parametrize("case", sorted(_loss_cases()))
def test_losses_match_jax(case):
    fn, args, kw = _loss_cases()[case]
    want = fn(jlosses)(*[jnp.asarray(a) for a in args], **kw)
    got = fn(losses)(*[torch.from_numpy(a) for a in args], **kw)
    assert rel(got, want) < LOSS_RTOL


def test_physics_cycle_loss_matches_jax(setup):
    jb, tb = setup["jbatches"][0], setup["batches"][0]
    rng = np.random.default_rng(6)
    amp = rng.random((2, 1, 64, 64)).astype(np.float32)
    ph = rng.normal(size=(2, 1, 64, 64)).astype(np.float32)
    dc = np.array([[0.55], [0.7]], np.float32).reshape(2, 1, 1, 1)
    want = jlosses.physics_cycle_loss(jnp.asarray(amp), jnp.asarray(ph), jnp.asarray(dc), jb["distance_style"],
                                      jb["content_holo"], setup["jcfg"].physics)
    got = losses.physics_cycle_loss(torch.from_numpy(amp), torch.from_numpy(ph), torch.from_numpy(dc),
                                    tb["distance_style"], tb["content_holo"], setup["cfg"].physics)
    assert rel(got, want) < LOSS_RTOL


# --------------------------------------------------------------------------
# generator_loss_fn: loss, aux and every gradient leaf
# --------------------------------------------------------------------------


LOSS_CASES = {
    "flagship": {},
    "perceptual_tv": dict(perceptual_weight=2.0, tv_weight=0.5, adv_weight=0.0),
}


class JaxRefs:
    """The JAX package's results, each computed once per module."""

    def __init__(self, s):
        self.s, self._loss, self._steps = s, {}, {}

    def loss_and_grads(self, case: str):
        """(loss, aux, grads) of ``jax.value_and_grad`` in float64: the net,
        the discriminator, params and batch in float64 under
        ``jax.enable_x64``."""
        if case not in self._loss:
            s = self.s
            jcfg, _ = configs(**LOSS_CASES[case])
            f64 = jnp.float64
            with jax.enable_x64(True):
                cast = functools.partial(jax.tree.map, lambda a: jnp.asarray(a, f64))
                fn = jax.jit(jax.value_and_grad(functools.partial(
                    j_loss_fn, net=JNet(width=0.25, dtype=f64, param_dtype=f64), physics=jcfg.physics,
                    cfg=jcfg.train, disc=JDisc(image_size=64, dtype=f64, param_dtype=f64)), has_aux=True))
                (loss, aux), grads = fn(cast(s["jparams"]), cast(s["jbatches"][0]), jax.random.key(2),
                                        disc_params=cast(s["jdisc_params"]))
                self._loss[case] = jax.device_get((loss, aux, grads))
        return self._loss[case]

    def steps(self, case: str):
        """The JAX states' fields (numpy) before and after each step, and aux."""
        if case not in self._steps:
            s = self.s
            jcfg, _ = configs(**STEP_CASES[case])
            adv = bool(jcfg.train.adv_weight)
            state = j_create(s["jparams"], jcfg.train, disc_params=s["jdisc_params"] if adv else None)
            step = j_make_step(s["jnet"], jcfg.physics, jcfg.train, disc=s["jdisc"] if adv else None)
            fields = ("step", "params", "opt_state", "disc_params", "disc_opt_state", "ema_params")
            snaps, auxes = [jax.device_get({f: getattr(state, f) for f in fields})], []
            for b in s["jbatches"]:
                state, aux = step(state, jax.tree.map(jnp.asarray, b), jax.random.key(2))
                snaps.append(jax.device_get({f: getattr(state, f) for f in fields}))
                auxes.append(jax.device_get(aux))
            self._steps[case] = (snaps, auxes)
        return self._steps[case]


@pytest.fixture(scope="module")
def jax_refs(setup):
    return JaxRefs(setup)


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_generator_loss_fn_matches_jax(case, setup, jax_refs):
    s = setup
    loss_j, aux_j, grads_j = jax_refs.loss_and_grads(case)
    _, cfg = configs(**LOSS_CASES[case])
    params = {k: v.clone().requires_grad_() for k, v in s["params"].items()}
    loss, aux = generator_loss_fn(params, s["batches"][0], net=s["net"], physics=cfg.physics, cfg=cfg.train,
                                  disc_params=s["disc_params"], disc=s["disc"])
    grads = torch.autograd.grad(loss, list(params.values()))
    assert set(aux) == set(aux_j)
    assert rel(loss, loss_j) < LOSS_RTOL
    for k in aux_j:
        if k != "g_t":
            assert rel(aux[k], aux_j[k]) < LOSS_RTOL, k
    assert rel(aux["g_t"], nchw(aux_j["g_t"])) < LEAF_TOL
    assert_grads_close(dict(zip(params, grads)), grads_j, case)


def assert_grads_close(got, want_tree, label):
    """Every leaf of ``got`` within LEAF_TOL of its max of the JAX tree."""
    want = convert_params(want_tree)
    errs = {k: rel(got[k], want[k]) for k in got}
    worst = max(errs, key=errs.get)
    assert errs[worst] < LEAF_TOL, (label, worst, errs[worst])


def test_frozen_encoder_grads_are_the_rest_of_jax_grads(setup, jax_refs):
    """Under ``freeze_encoder`` the step differentiates the rest only; those
    gradients are JAX's (whose ``multi_transform`` zeroes the encoder's)."""
    s = setup
    _, cfg = configs(freeze_encoder=True)
    _, _, grads_j = jax_refs.loss_and_grads("flagship")
    state = create_train_state(s["params"], cfg.train, disc_params=s["disc_params"], device="cpu")
    grads, _ = TrainStep(s["net"], cfg.physics, cfg.train, disc=s["disc"]).generator_grads(state, s["batches"][0])
    assert set(grads) == {k for k in convert_params(grads_j) if not k.startswith("encoder.")}
    assert_grads_close(grads, grads_j, "frozen encoder")


# --------------------------------------------------------------------------
# The optimizer alone, given the JAX package's gradients
# --------------------------------------------------------------------------


OPT_CASES = {
    "invtime_clipped_disc": dict(grad_scale=10.0, disc=True),
    "invtime_unclipped": dict(grad_scale=1e-4),
    "cosine_frozen": dict(grad_scale=10.0, lr_schedule="cosine", iterations=5, freeze_encoder=True),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_matches_optax_given_the_same_gradients(case, setup):
    """Three updates from the same gradients (seeded, JAX layout): the
    port's clip, Adam, schedule, frozen encoder and EMA, and the
    discriminator's Adam, against the JAX ``TrainState``'s."""
    s = setup
    kw = dict(OPT_CASES[case])
    scale, with_disc = kw.pop("grad_scale"), kw.pop("disc", False)
    jcfg, cfg = configs(lr=1e-3, **kw)
    jstate = j_create(s["jparams"], jcfg.train, disc_params=s["jdisc_params"] if with_disc else None)
    state = create_train_state(s["params"], cfg.train, disc_params=s["disc_params"] if with_disc else None,
                               device="cpu")
    tx, dtx = make_optimizer(cfg.train), make_disc_optimizer(cfg.train)
    update = jax.jit(lambda st, g, dg: st.apply_gradients(g) if dg is None
                     else st.apply_gradients(g).apply_disc_gradients(dg))
    rng = np.random.default_rng(7)
    for _ in range(N_STEPS):
        g = jax.tree.map(lambda p: scale * rng.standard_normal(size=p.shape, dtype=np.float32),
                         s["jparams"])
        dg = (jax.tree.map(lambda p: rng.standard_normal(size=p.shape, dtype=np.float32), s["jdisc_params"])
              if with_disc else None)
        jstate = update(jstate, g, dg)
        tg = convert_params(g)
        apply_gradients(state, {k: tg[k] for k in state.opt_state.mu}, tx, cfg.train.ema_decay)
        if with_disc:
            apply_disc_gradients(state, convert_params(dg), dtx)
    assert state.step == int(jstate.step) == N_STEPS
    assert state.opt_state.count == N_STEPS
    assert_leaves_close(state.params, jstate.params, "params", OPT_TOL)
    assert_leaves_close(state.ema_params, jstate.ema_params, "ema", OPT_TOL)
    if with_disc:
        assert_leaves_close(state.disc_params, jstate.disc_params, "discriminator", OPT_TOL)
    moved = {k for k in state.params if not torch.equal(state.params[k], s["params"][k])}
    assert moved == set(state.opt_state.mu)


# --------------------------------------------------------------------------
# Full steps, grad_accum and the resume from a JAX state
# --------------------------------------------------------------------------


STEP_CASES = {
    "flagship": {},
    "accum2_frozen_cosine": dict(grad_accum=2, adv_weight=0.0, freeze_encoder=True,
                                 lr_schedule="cosine", iterations=10),
}


def port_state(s, cfg):
    adv = bool(cfg.train.adv_weight)
    return create_train_state(s["params"], cfg.train, disc_params=s["disc_params"] if adv else None,
                              device="cpu")


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_full_steps_match_jax(case, setup, jax_refs):
    s = setup
    snaps, auxes = jax_refs.steps(case)
    _, cfg = configs(**STEP_CASES[case])
    state = port_state(s, cfg)
    step = TrainStep(s["net"], cfg.physics, cfg.train, disc=s["disc"] if cfg.train.adv_weight else None)
    for i, b in enumerate(s["batches"]):
        state, aux = step(state, b)
        assert set(aux) == set(auxes[i])
        # the first step starts from equal params: 1e-5; later ones from
        # params equal to 1e-4 of max
        tol = LOSS_RTOL if i == 0 else LEAF_TOL
        for k in aux:
            assert rel(aux[k], auxes[i][k]) < tol, (i, k)
    want = snaps[-1]
    assert state.step == int(want["step"]) == N_STEPS
    atol = STEP_LR_TOL * cfg.train.lr * N_STEPS
    assert_leaves_close(state.params, want["params"], "params", atol=atol)
    assert_leaves_close(state.ema_params, want["ema_params"], "ema", atol=atol)
    if cfg.train.adv_weight:
        assert_leaves_close(state.disc_params, want["disc_params"], "discriminator", atol=atol)
    if cfg.train.freeze_encoder:
        for k, v in state.params.items():
            if k.startswith("encoder."):
                assert torch.equal(v, s["params"][k]), k


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_resume_from_a_converted_jax_state(case, setup, jax_refs):
    """Two JAX steps, ``convert_train_state``, one port step: the JAX state
    after three steps."""
    s = setup
    snaps, _ = jax_refs.steps(case)
    _, cfg = configs(**STEP_CASES[case])
    state = convert_train_state(snaps[N_STEPS - 1], device="cpu")
    assert state.step == N_STEPS - 1 and state.opt_state.count == N_STEPS - 1
    fresh = port_state(s, cfg)
    assert set(state.opt_state.mu) == set(fresh.opt_state.mu)
    assert (state.disc_params is None) == (fresh.disc_params is None)
    step = TrainStep(s["net"], cfg.physics, cfg.train, disc=s["disc"] if cfg.train.adv_weight else None)
    state, _ = step(state, s["batches"][N_STEPS - 1])
    atol = STEP_LR_TOL * cfg.train.lr
    assert_leaves_close(state.params, snaps[N_STEPS]["params"], "params", atol=atol)
    assert_leaves_close(state.ema_params, snaps[N_STEPS]["ema_params"], "ema", atol=atol)
    if cfg.train.adv_weight:
        assert_leaves_close(state.disc_params, snaps[N_STEPS]["disc_params"], "discriminator", atol=atol)


# --------------------------------------------------------------------------
# The ring's gradient, checkpoints, train() and the CLI
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 3, 9, 7, 5), (1, 8, 16, 16, 4)])
def test_border_lines_function_gradient(shape):
    """The ``border_lines`` op (on the CPU its forward is the plain version) gives
    ``border_lines_plain``'s autograd gradients; under no_grad it keeps no
    graph."""
    b, c, h, w, o = shape
    g = torch.Generator().manual_seed(3)
    x = torch.randn(b, c, h, w, generator=g, requires_grad=True)
    k = torch.randn(o, c, 3, 3, generator=g, requires_grad=True)
    wr, wc = torch.randn(b, o, 2, w, generator=g), torch.randn(b, o, h, 2, generator=g)
    want = torch.autograd.grad(sum((t * u).sum() for t, u in zip(reflect_border.border_lines_plain(x, k), (wr, wc))),
                               (x, k))
    got = torch.autograd.grad(sum((t * u).sum() for t, u in zip(reflect_border.border_lines(x, k), (wr, wc))),
                              (x, k))
    for a, e in zip(got, want):
        assert torch.equal(a, e)
    with torch.no_grad():
        rows, _ = reflect_border.border_lines(x, k)
    assert rows.grad_fn is None


@pytest.mark.parametrize("backend", ["cuda", "einsum"])
def test_reflect_conv_ring_backends_keep_the_gradient(backend):
    """``ReflectConv``'s ring backends give ``matpad``'s gradients for x,
    weight and bias (``cuda`` goes through the ``border_lines`` op; on a CPU tensor
    its forward is the plain version): 1e-5 of max, fp32 sums."""
    g = torch.Generator().manual_seed(4)
    conv = ReflectConv(6, 5)
    x = torch.randn(2, 6, 12, 9, generator=g, requires_grad=True)
    up = torch.randn(2, 5, 12, 9, generator=g)
    grads = {}
    try:
        for b in (backend, "matpad"):
            set_reflect_backend(b)
            grads[b] = torch.autograd.grad((conv(x) * up).sum(), (x, conv.weight, conv.bias))
    finally:
        set_reflect_backend("auto")
    for a, e in zip(grads[backend], grads["matpad"]):
        assert rel(a, e) < 1e-5


def _tiny_run_config(tmp_path, **train_kw):
    _, cfg = configs(log_every=1, checkpoint_every=1, checkpoint_dir=str(tmp_path), **train_kw)
    return cfg


def test_checkpoint_round_trip_and_resume_equals_an_uninterrupted_run(tmp_path):
    bank = synth.golden_digit_bank(load_golden_suite(), size=32, subset=synth.GOLDEN_TRAIN_DIGITS)
    cfg = _tiny_run_config(tmp_path / "a", adv_weight=0.0)   # the discriminator's own test follows
    logs = []
    whole = train(cfg, bank=bank, iterations=2, device="cpu", log_fn=logs.append)
    assert len(logs) == 2 and whole.step == 2
    lines = [json.loads(line) for line in open(tmp_path / "a" / "train_metrics.jsonl")]
    assert [r["step"] for r in lines] == [1, 2]
    assert all(np.isfinite(v) for r in lines for v in r.values())
    assert latest_snapshot(str(tmp_path / "a")).endswith("iter_2")
    snap = str(tmp_path / "a" / "iter_1")

    # round trip: a fresh state restored from the snapshot, saved again, equal
    fresh = create_train_state(init_net_params(torch.Generator().manual_seed(9), width=0.25), cfg.train,
                               device="cpu")
    restored = restore_checkpoint(snap, fresh)
    again = restore_checkpoint(save_checkpoint(restored, str(tmp_path / "b")), fresh)
    assert again.step == restored.step == 1
    for a, b in ((again.params, restored.params), (again.ema_params, restored.ema_params),
                 (again.opt_state.mu, restored.opt_state.mu), (again.opt_state.nu, restored.opt_state.nu)):
        assert all(torch.equal(a[k], b[k]) for k in b)
    assert load_train_params(snap).keys() == restored.ema_params.keys()

    resumed = train(cfg, bank=bank, state=restored, iterations=1, device="cpu", log_fn=logs.append)
    for got, want in ((resumed.params, whole.params), (resumed.ema_params, whole.ema_params)):
        assert all(torch.equal(got[k], want[k]) for k in want)


def test_checkpoint_keeps_the_discriminator(tmp_path, setup):
    """A snapshot of an adversarial state restores its discriminator and
    its Adam state; restored into a run without one, they are ignored."""
    s = setup
    _, cfg = configs()
    state = port_state(s, cfg)
    grads = {k: torch.full_like(v, 0.5) for k, v in state.disc_params.items()}
    apply_disc_gradients(state, grads, make_disc_optimizer(cfg.train))
    path = save_checkpoint(state, str(tmp_path))
    back = restore_checkpoint(path, port_state(s, cfg))
    assert back.disc_opt_state.count == 1
    for a, b in ((back.disc_params, state.disc_params), (back.disc_opt_state.mu, state.disc_opt_state.mu)):
        assert all(torch.equal(a[k], b[k]) for k in b)
    _, plain = configs(adv_weight=0.0)
    assert restore_checkpoint(path, port_state(s, plain)).disc_params is None


def test_a_snapshot_serves(tmp_path, setup):
    s = setup
    _, cfg = configs(ema_decay=0.5)
    state = port_state(s, cfg)
    path = save_checkpoint(state, str(tmp_path))
    net = StyleTransferNet.from_state_dict(load_train_params(path), width=0.25)
    assert all(torch.equal(v, state.ema_params[k]) for k, v in net.state_dict().items())


def test_cli_train_runs_and_resumes_on_the_cpu(tmp_path, capsys):
    ckpt = tmp_path / "run"
    argv = ["train", "--cpu", "--iterations", "1", "--batch-size", "2", "--bank", "golden",
            "--checkpoint-dir", str(ckpt), "--log-every", "1", "--checkpoint-every", "0",
            "--ema-decay", "0.999", "--train-encoder", "--rotate-deg", "20",
            "--elastic-px", "2.5", "--reflect-backend", "einsum"]
    # --reflect-backend sets the process-wide border backend: restore it, or
    # every later test in this process runs its convs on the einsum border
    try:
        assert cli.main(argv) == 0
        out = capsys.readouterr().out
        assert "step 1 |" in out and "final checkpoint:" in out
        assert latest_snapshot(str(ckpt)).endswith("iter_1")
        # --resume continues the stream and the schedule from the snapshot
        assert cli.main(argv[:2] + ["--iterations", "2"] + argv[4:] + ["--resume"]) == 0
    finally:
        set_reflect_backend("auto")
    assert "resumed from iter_1 (step 1)" in capsys.readouterr().err
    assert latest_snapshot(str(ckpt)).endswith("iter_2")
    rows = [json.loads(line) for line in open(ckpt / "train_metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2] and "loss_supervised" in rows[0]


@pytest.mark.parametrize("flag", [
    ["--dtype", "bf16"], ["--remat"], ["--domain", "mars"], ["--bank", "mnist"],
    ["--partition", "megatron"], ["--partition", "pp"], ["--pipeline-devices", "2"],
    ["--dtype", "float16"],
])
def test_cli_train_rejects_flags_it_does_not_implement(flag, capsys):
    """Flags neither CLI has (``--remat``: it comes through ``TrainConfig``,
    as in the JAX package; ``--pipeline-devices``) and values outside a
    flag's choices (``--partition pp``: the JAX package's GPipe pipeline is no
    train partition there either) are refused by argparse with a message and
    exit code 2, never silently accepted. (``--domain``, ``--mat-root``,
    ``--bank bead|rbc``, ``--dtype bfloat16``, ``--tensorboard-dir`` and the
    mesh's ``--devices``, ``--partition`` and ``--model-devices`` are
    implemented: ``tests/test_torch_eval_cli.py``,
    ``tests/test_torch_train_bf16.py``, ``tests/test_torch_parallel.py``.)"""
    with pytest.raises(SystemExit) as exit_:
        cli.main(["train", "--cpu", "--iterations", "1", *flag])
    assert exit_.value.code == 2
    err = capsys.readouterr().err
    assert "unrecognized arguments" in err or "invalid choice" in err
