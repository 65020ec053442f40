"""Mixed-precision training, ``remat`` and ``--tensorboard-dir`` on the port
against the JAX package on the CPU.

Width 0.25, 64^2, B = 2, the flagship's loss weights (``tests/test_torch_train.py``'s
``configs``: adversarial on, EMA, clip, the encoder trained), the same
params and the same batch (the JAX package's ``synth_batch`` on
``fold_in(key(0), 0)``, the first batch of ``test_torch_train.py``).
Tolerances:

* the bf16 ``generator_loss_fn`` against the JAX package's bf16
  ``jax.value_and_grad``: the loss and every ``aux`` term within 1e-2
  relative (read 1.2e-4 at most: the port rounds where XLA rounds, up to the
  sums' order and XLA's excess precision inside its fusions); ``g_t``, the
  decoder's bf16 output, within 8 bf16 ulps of its max (eleven bf16 convs,
  each of which may round an element the other way: read 3.2);
* the bf16 gradients' distances from the JAX float64 gradient
  (``jax.enable_x64``, net and discriminator in float64), each the leaf's
  L2 norm of the difference, on GRAD_BATCHES batches, against the JAX bf16
  gradient's own distances, the issue's ratio 1.5: each decoder leaf's
  median over the batches within 1.5 times the JAX one's plus 1e-4 of the
  leaf's norm; for the encoder's and the distance head's leaves, the median
  over those leaves of the two distances' ratio, its median over the
  batches, within 1.5. bf16 gradients read 5-40 % of a leaf's norm off the
  float64 ones in both packages, and the encoder's and head's carry one
  ill-conditioned factor a batch (the physics loss's gradient through the
  distance head), so their ratio is a heavy-tailed draw per leaf and batch:
  over the batches of ``fold_in(key(0), 0..5)`` one batch's worst read 2.4
  (the stem's 3 weights, whose gradients sum 4,096 products of a large mean
  and a small, cancelling factor), a leaf's median over three batches up
  to 1.56. On those six batches the rule read at most 1.20 (decoder, any
  three batches) and 1.03 (the group);
* ``ReflectConv`` in bf16 under ``einsum`` against the JAX
  ``ReflectConv(dtype=bfloat16)`` under ``einsum``, and ``matpad`` against
  ``matpad``: within one bf16 ulp of max;
* train-mode dropout in bf16 against flax's ``Dropout`` given the same
  masks: the head's output within one bf16 ulp of max;
* ``remat``: the port's step with it equal to the step without it, dropout
  on: the loss within 1e-5 relative, params within 1e-6 of each leaf's max;
  the port's ``remat`` step against the JAX package's ``remat`` step (fp32):
  ``test_torch_train.py``'s rule for one full step (aux 1e-5 relative,
  params 1e-4 of each leaf's max plus 0.1 lr);
* a JAX bf16 train state converted and stepped once in the port against the
  JAX package's bf16 step: aux within 1e-2 relative, params within 1e-4 of
  each leaf's max plus 2 lr. Adam's first step moves an element by
  lr g / (|g| + eps), +-lr but for the tiniest gradients, and bf16 gradient
  noise flips the sign of a small gradient in one run or the other: biases
  that start at zero read up to 1.9 lr apart.
"""

import contextlib
import dataclasses
import functools
import io
import json
import os
import struct
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import (
    SMALL_DATA,
    STEP_LR_TOL,
    assert_leaves_close,
    configs,
    jax_batch_to_torch,
    nchw,
    rel,
    to_jax_tree,
)
from torch_cpu_threads import warm_few_torch_threads  # noqa: F401

from style_transfer_based_holographic_imaging_tpu.data import load_golden_suite as j_load_goldens
from style_transfer_based_holographic_imaging_tpu.data import synth as jsynth
from style_transfer_based_holographic_imaging_tpu.models import PatchDiscriminator as JDisc
from style_transfer_based_holographic_imaging_tpu.models import StyleTransferNet as JNet
from style_transfer_based_holographic_imaging_tpu.models import layers as jlayers
from style_transfer_based_holographic_imaging_tpu.models.distance import DistanceMLP as JDistanceMLP
from style_transfer_based_holographic_imaging_tpu.train.loop import generator_loss_fn as j_loss_fn
from style_transfer_based_holographic_imaging_tpu.train.loop import make_train_step as j_make_step
from style_transfer_based_holographic_imaging_tpu.train.state import create_train_state as j_create
from style_transfer_based_holographic_imaging_tpu_torch import ExperimentConfig, cli
from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite, synth
from style_transfer_based_holographic_imaging_tpu_torch.interop import convert_params, convert_train_state
from style_transfer_based_holographic_imaging_tpu_torch.models import (
    PatchDiscriminator,
    ReflectConv,
    StyleTransferNet,
    init_net_params,
    init_params,
    set_reflect_backend,
)
from style_transfer_based_holographic_imaging_tpu_torch.models.distance import DistanceMLP
from style_transfer_based_holographic_imaging_tpu_torch.train import (
    TrainStep,
    compute_dtype,
    create_train_state,
    generator_loss_fn,
    latest_snapshot,
    train,
)

BF16 = torch.bfloat16
AUX_RTOL = 1e-2
G_T_ULPS = 8
GRAD_RATIO = 1.5
GRAD_SLACK = 1e-4
GRAD_BATCHES = 3
REMAT_LOSS_RTOL = 1e-5
REMAT_PARAM_TOL = 1e-6
BF16_STEP_LR = 2.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def fresh(tree):
    """Copies of a JAX tree's arrays: the JAX step donates its state."""
    return jax.tree.map(jnp.array, tree)


def bf16_ulp_of_max(ref) -> float:
    """One bf16 ulp at the largest |ref|: 2^(exponent - 7)."""
    m = float(np.abs(np.asarray(ref, np.float64)).max())
    return 2.0 ** (np.floor(np.log2(m)) - 7)


@pytest.fixture(scope="module")
def s():
    jcfg, cfg = configs()
    bank = jsynth.golden_digit_bank(j_load_goldens(), size=32, subset=jsynth.GOLDEN_TRAIN_DIGITS)
    jbatches = [jax.device_get(jsynth.synth_batch(jax.random.fold_in(jax.random.key(0), i), jnp.asarray(bank),
                                                  data=jcfg.data, physics=jcfg.physics, return_gt=True))
                for i in range(GRAD_BATCHES)]
    params = init_net_params(torch.Generator().manual_seed(0), width=0.25)
    disc = PatchDiscriminator(image_size=64)
    disc_params = init_params(disc, torch.Generator().manual_seed(1))
    net = StyleTransferNet(width=0.25)
    return dict(jcfg=jcfg, cfg=cfg, jbatches=jbatches, batches=[jax_batch_to_torch(b) for b in jbatches],
                params=params, disc_params=disc_params, net=net, disc=disc,
                jparams=to_jax_tree(params), jdisc_params=to_jax_tree(disc_params))


@pytest.fixture(scope="module")
def jax_loss(s):
    """(loss, aux, grads) of the JAX package's bf16 and float64
    ``jax.value_and_grad(generator_loss_fn)``, one a batch."""
    out = {"bf16": [], "f64": []}
    jcfg = s["jcfg"]
    for name, dt in (("bf16", jnp.bfloat16), ("f64", jnp.float64)):
        with jax.enable_x64(name == "f64"):
            net_kw = dict(dtype=dt) if name == "bf16" else dict(dtype=dt, param_dtype=dt)
            disc_kw = {} if name == "bf16" else dict(dtype=dt, param_dtype=dt)
            cast = (lambda t: t) if name == "bf16" else functools.partial(
                jax.tree.map, lambda a: jnp.asarray(a, jnp.float64))
            fn = jax.jit(jax.value_and_grad(functools.partial(
                j_loss_fn, net=JNet(width=0.25, **net_kw), physics=jcfg.physics, cfg=jcfg.train,
                disc=JDisc(image_size=64, **disc_kw)), has_aux=True))
            for batch in s["jbatches"]:
                (loss, aux), grads = fn(cast(s["jparams"]), cast(batch), jax.random.key(2),
                                        disc_params=cast(s["jdisc_params"]))
                out[name].append(jax.device_get((loss, aux, grads)))
    return out


def _port_bf16_loss(s, backend="auto", batch=0):
    params = {k: v.clone().requires_grad_() for k, v in s["params"].items()}
    set_reflect_backend(backend)
    try:
        loss, aux = generator_loss_fn(params, s["batches"][batch], net=s["net"], physics=s["cfg"].physics,
                                      cfg=s["cfg"].train, disc_params=s["disc_params"], disc=s["disc"],
                                      dtype=BF16)
        grads = torch.autograd.grad(loss, list(params.values()))
    finally:
        set_reflect_backend("auto")
    return loss, aux, dict(zip(params, grads))


@pytest.mark.parametrize("backend", ["matpad", "einsum"])
def test_bf16_generator_loss_matches_jax_and_its_gradients_the_float64_ones(backend, s, jax_loss):
    """The JAX package's bf16 step runs its default ``matpad``; the port's
    ``einsum`` ring (the ``cuda`` backend's plain version) gives the same
    bounds."""
    loss_j, aux_j, _ = jax_loss["bf16"][0]
    loss, aux, _ = _port_bf16_loss(s, backend)
    assert loss.dtype == torch.float32 and aux["g_t"].dtype == BF16
    assert set(aux) == set(aux_j)
    assert rel(loss, loss_j) < AUX_RTOL
    for k in aux_j:
        if k != "g_t":
            assert aux[k].dtype == torch.float32, k
            assert rel(aux[k], aux_j[k]) < AUX_RTOL, k
    g_t = nchw(np.asarray(aux_j["g_t"], np.float32))
    assert float((aux["g_t"].detach().float() - torch.from_numpy(g_t)).abs().max()) <= G_T_ULPS * bf16_ulp_of_max(g_t)
    mine, theirs = [], []  # each leaf's distance from float64 over its norm, one dict a batch
    for i in range(GRAD_BATCHES):
        grads = _port_bf16_loss(s, backend, batch=i)[2]
        jb, f64 = convert_params(jax_loss["bf16"][i][2]), convert_params(jax_loss["f64"][i][2])
        assert set(grads) == set(f64)
        want = {k: v.double() for k, v in f64.items()}
        mine.append({k: float((grads[k].double() - w).norm() / w.norm()) for k, w in want.items()})
        theirs.append({k: float((jb[k].double() - w).norm() / w.norm()) for k, w in want.items()})
    decoder = [k for k in mine[0] if k.startswith("decoder.")]
    rest = [k for k in mine[0] if k not in decoder]
    shares = {k: (np.median([d[k] for d in mine]) - GRAD_SLACK) / np.median([d[k] for d in theirs])
              for k in decoder}
    worst = max(shares, key=shares.get)
    assert shares[worst] <= GRAD_RATIO, (worst, shares[worst])
    group = np.median([np.median([m[k] / t[k] for k in rest]) for m, t in zip(mine, theirs)])
    assert group <= GRAD_RATIO, group


def test_bf16_step_keeps_the_state_and_the_losses_fp32(s):
    cfg = s["cfg"]
    state = create_train_state(s["params"], cfg.train, disc_params=s["disc_params"], device="cpu")
    step = TrainStep(s["net"], cfg.physics, cfg.train, disc=s["disc"], dtype=compute_dtype("bf16"))
    state, aux = step(state, s["batches"][0])
    assert state.step == 1 and aux["loss_disc"].dtype == torch.float32
    assert all(v.dtype == torch.float32 and torch.isfinite(v).all() for v in aux.values())
    for tree in (state.params, state.ema_params, state.opt_state.mu, state.opt_state.nu, state.disc_params,
                 state.disc_opt_state.mu, state.disc_opt_state.nu):
        assert all(v.dtype == torch.float32 and torch.isfinite(v).all() for v in tree.values())
    moved = {k for k in state.params if not torch.equal(state.params[k], s["params"][k])}
    assert moved == set(state.params)


@pytest.mark.parametrize("name", ["bfloat16", "bf16", "float32", "fp32", "float16", "int8"])
def test_model_dtype_names(name):
    from style_transfer_based_holographic_imaging_tpu_torch.config import ModelConfig

    if name in ("float16", "int8"):
        with pytest.raises(ValueError, match="ModelConfig.dtype"):
            ModelConfig(dtype=name)
        with pytest.raises(ValueError, match="ModelConfig.dtype"):
            compute_dtype(name)
        return
    assert ModelConfig(dtype=name).dtype == name
    assert compute_dtype(name) == (BF16 if name.startswith("b") else torch.float32)


@pytest.mark.parametrize("backend", ["einsum", "matpad"])
def test_bf16_reflect_conv_matches_jax(backend):
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 32, 16, 12)).astype(np.float32)
    k = (rng.normal(size=(24, 32, 3, 3)) * (2.0 / (9 * 32)) ** 0.5).astype(np.float32)
    b = (0.1 * rng.normal(size=24)).astype(np.float32)
    conv = ReflectConv(32, 24)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(k))
        conv.bias.copy_(torch.from_numpy(b))
    jconv = jlayers.ReflectConv(features=24, dtype=jnp.bfloat16)
    jp = {"params": {"kernel": jnp.asarray(np.transpose(k, (2, 3, 1, 0))), "bias": jnp.asarray(b)}}
    jlayers.set_reflect_backend(backend)
    set_reflect_backend(backend)
    try:
        want = np.asarray(jax.jit(jconv.apply)(jp, jnp.asarray(x).transpose(0, 2, 3, 1)), np.float32)
        with torch.no_grad():
            got = conv(torch.from_numpy(x), BF16)
    finally:
        jlayers.set_reflect_backend("auto")
        set_reflect_backend("auto")
    assert got.dtype == BF16
    want = nchw(want)
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= bf16_ulp_of_max(want), (err, bf16_ulp_of_max(want))


def test_bf16_dropout_matches_flax_given_the_same_masks(monkeypatch):
    """The distance head in bf16, train mode: its masks drawn from a
    torch generator, handed to flax's ``Dropout`` in the same order."""
    rng = np.random.default_rng(13)
    mean = rng.normal(size=(2, 64, 1, 1)).astype(np.float32)
    std = np.abs(rng.normal(size=(2, 64, 1, 1))).astype(np.float32) + 0.1
    head = DistanceMLP(64)
    state = init_params(head, torch.Generator().manual_seed(4))
    head.load_state_dict(state)
    g = torch.Generator().manual_seed(21)
    masks = [torch.rand(shape, generator=g) < 0.5 for shape in ((2, 1024), (2, 1024), (2, 512))]
    fed = iter(masks)

    def bernoulli(key, p=0.5, shape=None):
        return jnp.asarray(next(fed).numpy())

    import flax.linen.stochastic as stochastic

    monkeypatch.setattr(stochastic.random, "bernoulli", bernoulli)
    jhead = JDistanceMLP(dtype=jnp.bfloat16)
    jp = to_jax_tree(state)
    want = np.asarray(jax.jit(lambda p, m, sd: jhead.apply(p, (m, sd), deterministic=False,
                                                           rngs={"dropout": jax.random.key(0)}))(
        jp, jnp.asarray(mean).transpose(0, 2, 3, 1), jnp.asarray(std).transpose(0, 2, 3, 1)), np.float32)
    with torch.no_grad():
        got = head((torch.from_numpy(mean), torch.from_numpy(std)), dtype=BF16,
                   dropout=torch.Generator().manual_seed(21))
    assert got.dtype == BF16
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= bf16_ulp_of_max(want), (err, want, got)
    # the masks reached the head: another generator draws another output
    with torch.no_grad():
        other = head((torch.from_numpy(mean), torch.from_numpy(std)), dtype=BF16,
                     dropout=torch.Generator().manual_seed(22))
    assert not torch.equal(other, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_step_equals_the_plain_step(dtype, s):
    """With dropout on: the recompute draws the masks the forward drew."""
    _, cfg = configs(use_dropout=True)
    results = []
    for remat in (False, True):
        run = dataclasses.replace(cfg.train, remat=remat)
        state = create_train_state(s["params"], run, disc_params=s["disc_params"], device="cpu")
        step = TrainStep(s["net"], cfg.physics, run, disc=s["disc"], dtype=compute_dtype(dtype))
        gen = synth.stream_generator(cfg.data.seed + 2, 0)
        state, aux = step(state, s["batches"][0], gen)
        results.append((state, aux))
    (plain, aux_p), (remat_state, aux_r) = results
    assert set(aux_p) == set(aux_r)
    for k in aux_p:
        assert rel(aux_r[k], aux_p[k].double().numpy()) < REMAT_LOSS_RTOL, k
    assert_leaves_close(remat_state.params, plain.params, "remat params", REMAT_PARAM_TOL)
    assert_leaves_close(remat_state.disc_params, plain.disc_params, "remat discriminator", REMAT_PARAM_TOL)
    # dropout was on: a step without it differs
    _, off = configs()
    state = create_train_state(s["params"], off.train, disc_params=s["disc_params"], device="cpu")
    _, aux_off = TrainStep(s["net"], off.physics, off.train, disc=s["disc"],
                           dtype=compute_dtype(dtype))(state, s["batches"][0])
    assert float(aux_off["loss_distance"]) != float(aux_p["loss_distance"])


def test_remat_step_matches_the_jax_remat_step(s):
    jcfg, cfg = configs(remat=True)
    jstate = j_create(fresh(s["jparams"]), jcfg.train, disc_params=fresh(s["jdisc_params"]))
    jstep = j_make_step(JNet(width=0.25), jcfg.physics, jcfg.train, disc=JDisc(image_size=64))
    jstate, jaux = jstep(jstate, jax.tree.map(jnp.asarray, s["jbatches"][0]), jax.random.key(2))
    jaux = jax.device_get(jaux)
    state = create_train_state(s["params"], cfg.train, disc_params=s["disc_params"], device="cpu")
    state, aux = TrainStep(s["net"], cfg.physics, cfg.train, disc=s["disc"])(state, s["batches"][0])
    assert set(aux) == set(jaux)
    for k in aux:
        assert rel(aux[k], jaux[k]) < 1e-5, k
    atol = STEP_LR_TOL * cfg.train.lr
    assert_leaves_close(state.params, jstate.params, "params", atol=atol)
    assert_leaves_close(state.disc_params, jstate.disc_params, "discriminator", atol=atol)


def test_a_jax_bf16_train_state_converts_and_steps_once(s):
    jcfg, cfg = configs()
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, dtype="bfloat16"))
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype="bfloat16"))
    jstate = j_create(fresh(s["jparams"]), jcfg.train, disc_params=fresh(s["jdisc_params"]))
    fields = ("step", "params", "opt_state", "disc_params", "disc_opt_state", "ema_params")
    start = jax.device_get({f: getattr(jstate, f) for f in fields})
    jstep = j_make_step(JNet(width=0.25, dtype=jnp.bfloat16), jcfg.physics, jcfg.train, disc=JDisc(image_size=64))
    jstate, jaux = jstep(jstate, jax.tree.map(jnp.asarray, s["jbatches"][1]), jax.random.key(2))
    want, jaux = jax.device_get({f: getattr(jstate, f) for f in fields}), jax.device_get(jaux)
    state = convert_train_state(start, device="cpu")
    assert all(v.dtype == torch.float32 for v in state.params.values())
    step = TrainStep(s["net"], cfg.physics, cfg.train, disc=s["disc"], dtype=compute_dtype(cfg.model.dtype))
    state, aux = step(state, s["batches"][1])
    assert state.step == int(want["step"]) == 1
    assert set(aux) == set(jaux)
    for k in aux:
        assert rel(aux[k], jaux[k]) < AUX_RTOL, k
    atol = BF16_STEP_LR * cfg.train.lr
    assert_leaves_close(state.params, want["params"], "params", atol=atol)
    assert_leaves_close(state.ema_params, want["ema_params"], "ema", atol=atol)
    assert_leaves_close(state.disc_params, want["disc_params"], "discriminator", atol=atol)


# --------------------------------------------------------------------------
# --tensorboard-dir
# --------------------------------------------------------------------------


def read_scalars(logdir: str) -> dict:
    """``{tag: [(step, value), ...]}`` of the event files in ``logdir``: the
    TFRecord frames (length, its CRC, the record, its CRC) parsed as
    tensorboardX's ``Event`` protos."""
    from tensorboardX.proto.event_pb2 import Event

    out = {}
    for name in sorted(os.listdir(logdir)):
        with open(os.path.join(logdir, name), "rb") as f:
            blob = f.read()
        pos = 0
        while pos < len(blob):
            (n,) = struct.unpack("<Q", blob[pos:pos + 8])
            ev = Event.FromString(blob[pos + 12:pos + 12 + n])
            pos += 12 + n + 4
            for v in ev.summary.value:
                out.setdefault(v.tag, []).append((ev.step, v.simple_value))
    return out


def _tiny_train(tmp_path, name, **train_kw):
    _, cfg = configs(log_every=1, checkpoint_every=0, checkpoint_dir=str(tmp_path / name), adv_weight=0.0,
                     **train_kw)
    bank = synth.golden_digit_bank(load_golden_suite(), size=32, subset=synth.GOLDEN_TRAIN_DIGITS)
    train(cfg, bank=bank, iterations=2, device="cpu", log_fn=lambda line: None)
    with open(tmp_path / name / "train_metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def test_tensorboard_dir_mirrors_the_logged_scalars(tmp_path, monkeypatch):
    rows = _tiny_train(tmp_path, "run", tensorboard_dir=str(tmp_path / "tb"))
    scalars = read_scalars(str(tmp_path / "tb"))
    assert set(scalars) == {f"train/{k}" for k in rows[0] if k != "step"}
    for tag, points in scalars.items():
        assert [p[0] for p in points] == [1, 2], tag
        for (step, value), row in zip(points, rows):
            assert value == pytest.approx(row[tag[len("train/"):]], rel=1e-6, abs=0.051), tag
    # without tensorboardX: one warning, and the JSONL as it was
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        again = _tiny_train(tmp_path, "again", tensorboard_dir=str(tmp_path / "tb2"))
    warnings = [line for line in err.getvalue().splitlines() if "tensorboardX is unavailable" in line]
    assert len(warnings) == 1
    assert not os.path.exists(tmp_path / "tb2") or not os.listdir(tmp_path / "tb2")
    assert [{k: v for k, v in r.items() if k != "img_per_sec"} for r in again] == \
        [{k: v for k, v in r.items() if k != "img_per_sec"} for r in rows]


def test_cli_train_bf16_with_tensorboard_on_the_cpu(tmp_path, capsys):
    """The w125 recipe's dtype through ``cli train --dtype bfloat16`` (the
    CLI trains width 1.0; ``train()`` takes the recipe's width, above), with
    the scalars mirrored."""
    ckpt, tb = tmp_path / "run", tmp_path / "tb"
    assert cli.main(["train", "--cpu", "--dtype", "bfloat16", "--iterations", "1", "--batch-size", "2",
                     "--bank", "golden", "--checkpoint-dir", str(ckpt), "--log-every", "1",
                     "--checkpoint-every", "0", "--train-encoder", "--rotate-deg", "20", "--elastic-px", "2.5",
                     "--tensorboard-dir", str(tb)]) == 0
    assert "step 1 |" in capsys.readouterr().out
    rows = [json.loads(line) for line in open(ckpt / "train_metrics.jsonl")]
    assert len(rows) == 1 and all(np.isfinite(v) for v in rows[0].values())
    assert "train/loss_total" in read_scalars(str(tb))
    snap = latest_snapshot(str(ckpt))
    from style_transfer_based_holographic_imaging_tpu_torch.train import load_train_params

    assert all(v.dtype == torch.float32 for v in load_train_params(snap).values())


def test_the_w125_recipe_trains_from_its_config_on_the_cpu(tmp_path):
    """``checkpoints_w125/config.json`` (width 1.25, bf16, the warp on) cut to
    the tests' size: finite losses, fp32 params."""
    with open(os.path.join(REPO, "checkpoints_w125", "config.json")) as f:
        cfg = ExperimentConfig.from_json(f.read())
    assert cfg.model.dtype == "bfloat16" and cfg.model.width == 1.25 and cfg.data.rotate_deg == 20.0
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, width=0.25),
                              data=dataclasses.replace(cfg.data, **SMALL_DATA),
                              train=dataclasses.replace(cfg.train, log_every=1, checkpoint_every=0,
                                                        checkpoint_dir=str(tmp_path)))
    bank = synth.golden_digit_bank(load_golden_suite(), size=32, subset=synth.GOLDEN_TRAIN_DIGITS)
    state = train(cfg, bank=bank, iterations=1, device="cpu", log_fn=lambda line: None)
    rows = [json.loads(line) for line in open(tmp_path / "train_metrics.jsonl")]
    assert all(np.isfinite(v) for v in rows[0].values())
    assert all(v.dtype == torch.float32 for v in state.params.values())
