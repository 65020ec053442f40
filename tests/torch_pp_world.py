"""The rank side of ``tests/test_torch_fft_sharding.py`` and
``tests/test_torch_pp.py``: the inputs both files share and what each
process of a spawned ``gloo`` world on the CPU runs, in a module that
imports no JAX (each rank imports it afresh).

``world(n)`` launches an ``n``-rank world once a test session (both files
use its results, in one process or in two xdist workers) and returns each
rank's results. The 2-rank world runs
every check of ``CHECKS2``, the 4-rank world those of ``CHECKS4``:

* ``fft``: ``sharded_propagate`` on the rank's rows of ``inputs()["field"]``
  with and without the pad, with the band limit at mm distances, the
  gradient of ``sum |out|^2`` in its rows, and the ``ValueError`` on a
  padded side the ranks do not divide;
* ``asm``: ``propagate(backend="cuda")`` (the ops ``holostyle::asm_const``
  and ``asm_dynamic``; their plain versions on the CPU) on the rank's
  share of a batch;
* ``retrieval`` and ``retrieval_ph``: the pipeline retrieval with the
  refocus, and the rank's stage's parameters;
* ``finetune``: four fine-tune steps, the first one's gradients of this
  stage and each one's loss;
* ``train`` and ``train_adv``: a full training step's loss terms and this
  stage's gradients (and the discriminator's change with the adversarial
  term).
"""

import atexit
import fcntl
import functools
import os
import pickle
import tempfile

import numpy as np
import torch

from style_transfer_based_holographic_imaging_tpu_torch.config import DataConfig, PhysicsConfig, TrainConfig
from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite, synth
from style_transfer_based_holographic_imaging_tpu_torch.models import PatchDiscriminator, init_net_params, init_params
from style_transfer_based_holographic_imaging_tpu_torch.ops.asm import propagate
from style_transfer_based_holographic_imaging_tpu_torch.parallel import (
    launch,
    make_mesh,
    make_pipeline_finetune_fn,
    make_pipeline_retrieval_fn,
    make_pipeline_train_fn,
    sharded_propagate,
)
from style_transfer_based_holographic_imaging_tpu_torch.utils import jax_random

WIDTH, IMAGE, N_MICRO, FFT_SIDE = 0.25, 32, 2, 64
KW = dict(wavelength=532e-9, pixel_size=1.5e-6)
FFT_D = (3e-4, 7e-4)
FFT_D_MM = (6e-3, 1.2e-2)          # mm-range: the band limit matters there
D_STYLE = 0.2
FINETUNE_LR, FINETUNE_STEPS = 1e-4, 4
TRAIN_LR = 1e-4
# The JAX package's tests/test_parallel.py training weights.
TRAIN_CFG = dict(content_weight=1.0, style_weight=1.0, physics_weight=10.0, distance_weight=20.0,
                 supervised_weight=10.0, adv_weight=0.0)
DISC = dict(image_size=IMAGE, conv_dim=8, repeat_num=4)
WORLD_TIMEOUT_S = 300.0

CHECKS2 = ("fft", "asm", "retrieval", "retrieval_ph", "finetune", "train", "train_adv")
CHECKS4 = ("fft", "retrieval", "retrieval_ph", "finetune")


def train_config(adv: bool = False) -> TrainConfig:
    return TrainConfig(**{**TRAIN_CFG, "adv_weight": 1.0 if adv else 0.0})


@functools.lru_cache(maxsize=1)
def inputs():
    """Every input, numpy-seeded (JAX-free, the same in every process)."""
    rng = np.random.default_rng(0)
    f = FFT_SIDE
    field = (rng.random((2, 1, f, f)) + 1j * rng.random((2, 1, f, f))).astype(np.complex64)
    c4 = max(int(round(512 * WIDTH)), 8)
    data = DataConfig(batch_size=4, image_size=IMAGE, digit_pad=8)
    bank = synth.golden_digit_bank(load_golden_suite(), size=16, subset=synth.GOLDEN_TRAIN_DIGITS)
    batch = synth.synth_batch_from_key(jax_random.key(0), torch.from_numpy(np.asarray(bank)), data,
                                       PhysicsConfig(), return_gt=True)
    return {
        "field": field,
        "holo": rng.uniform(0.1, 1.0, (8, 1, IMAGE, IMAGE)).astype(np.float32),
        "sm": rng.normal(size=(1, 1, 1, c4)).astype(np.float32),
        "ss": rng.uniform(0.5, 1.5, (1, 1, 1, c4)).astype(np.float32),
        "ft_sm": rng.random((1, 1, 1, c4), dtype=np.float32),
        "params": init_net_params(torch.Generator().manual_seed(0), width=WIDTH),
        "params_ph": init_net_params(torch.Generator().manual_seed(0), width=WIDTH, with_phase_decoder=True),
        "disc_params": init_params(PatchDiscriminator(**DISC), torch.Generator().manual_seed(2)),
        "batch": {k: v.numpy() for k, v in batch.items()},
        "asm_field": (rng.random((4, 1, IMAGE, IMAGE)) + 1j * rng.random((4, 1, IMAGE, IMAGE))).astype(
            np.complex64),
        "asm_d": rng.uniform(2e-4, 8e-4, (4, 1, 1, 1)).astype(np.float32),
    }


def jax_tree(state):
    """A port state dict as the JAX package's nested params tree (numpy),
    under ``'params'``."""
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
        node["kernel" if leaf == "weight" else "bias"] = a
    return {"params": tree}


def _fft(rank, n, inp):
    mesh = make_mesh(devices=["cpu"] * n)
    f = torch.from_numpy(inp["field"])
    mine = f.chunk(n, -2)[rank]
    d = torch.tensor(FFT_D).reshape(2, 1, 1, 1)
    d_mm = torch.tensor(FFT_D_MM).reshape(2, 1, 1, 1)
    out = {
        "pad": sharded_propagate(mine, d, mesh=mesh, **KW),
        "no_pad": sharded_propagate(mine[:1], 5e-4, mesh=mesh, pad=False, **KW),
        "band_limit": sharded_propagate(mine, d_mm, mesh=mesh, band_limit=True, **KW),
    }
    x = mine[:1].clone().requires_grad_(True)
    (sharded_propagate(x, 4e-4, mesh=mesh, **KW).abs() ** 2).sum().backward()
    out["grad"] = x.grad
    try:   # 33 columns pad to 65: no rank count divides them
        sharded_propagate(torch.zeros((1, 1, 16 // n, 33), dtype=torch.complex64), 3e-4, mesh=mesh, **KW)
        out["raises"] = False
    except ValueError:
        out["raises"] = True
    return out


def _asm(rank, n, inp):
    f = torch.from_numpy(inp["asm_field"]).chunk(n)[rank]
    d = torch.from_numpy(inp["asm_d"]).chunk(n)[rank]
    return {"const": propagate(f, 5e-4, backend="cuda", **KW), "dynamic": propagate(f, d, backend="cuda", **KW)}


def _retrieval(n, inp, params):
    mesh = make_mesh(devices=["cpu"] * n, axis_names=("pipe",))
    fn = make_pipeline_retrieval_fn(params, mesh, n_micro=4, image_size=IMAGE, physics=PhysicsConfig(),
                                    width=WIDTH)
    out = fn(inp["holo"], inp["sm"], inp["ss"], D_STYLE)
    try:
        fn(inp["holo"][:6], inp["sm"], inp["ss"], D_STYLE)
        raises = False
    except ValueError:
        raises = True
    return {"out": out, "stages": fn.stages, "stage_params": fn.stage_params, "raises": raises}


def _finetune(n, inp):
    mesh = make_mesh(devices=["cpu"] * n, axis_names=("pipe",))
    step, state = make_pipeline_finetune_fn(inp["params"], mesh, n_micro=N_MICRO, image_size=IMAGE,
                                            physics=PhysicsConfig(), lr=FINETUNE_LR, width=WIDTH)
    sm = inp["ft_sm"]
    ss = sm + 0.5
    state, aux, grads = step(state, inp["batch"], sm, ss, with_grads=True)
    losses = [float(aux["loss_total"])]
    for _ in range(FINETUNE_STEPS - 1):
        state, aux = step(state, inp["batch"], sm, ss)
        losses.append(float(aux["loss_total"]))
    return {"loss": losses[0], "grads": grads, "losses": losses, "t": float(state[3])}


def _train(n, inp, adv):
    mesh = make_mesh(devices=["cpu"] * n, axis_names=("pipe",))
    disc = PatchDiscriminator(**DISC) if adv else None
    step, state = make_pipeline_train_fn(inp["params"], mesh, n_micro=N_MICRO, image_size=IMAGE,
                                         physics=PhysicsConfig(), cfg=train_config(adv), lr=TRAIN_LR,
                                         width=WIDTH, disc=disc,
                                         disc_params=inp["disc_params"] if adv else None)
    new, aux, grads = step(state, inp["batch"], with_grads=True)
    out = {"aux": {k: float(v) for k, v in aux.items()}, "grads": grads}
    if adv:
        out["disc_moved"] = max(float((new[4][k] - state[4][k]).abs().max()) for k in state[4])
    return out


def world_checks(rank, n, checks):
    """Every check of ``checks`` on this rank; tensors to the parent."""
    torch.manual_seed(0)
    inp = inputs()
    out = {}
    for name in checks:
        if name == "fft":
            out[name] = _fft(rank, n, inp)
        elif name == "asm":
            out[name] = _asm(rank, n, inp)
        elif name in ("retrieval", "retrieval_ph"):
            out[name] = _retrieval(n, inp, inp["params_ph" if name.endswith("_ph") else "params"])
        elif name == "finetune":
            out[name] = _finetune(n, inp)
        elif name in ("train", "train_adv"):
            out[name] = _train(n, inp, name == "train_adv")
    return out


@functools.lru_cache(maxsize=None)
def world(n: int):
    """The ``n``-rank world's results, in rank order: launched once a test
    session (a hung collective fails it within WORLD_TIMEOUT_S). Under
    xdist the two files may run in two workers: the first to ask launches
    the world under a file lock and leaves its results in the temporary
    directory, where the other reads them (tens of MB, removed when the
    launching process exits)."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID") or str(os.getpid())
    path = os.path.join(tempfile.gettempdir(), f"holostyle_pp_world_{run}_{n}.pkl")
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            with open(path, "rb") as f:
                return pickle.load(f)
        checks = CHECKS2 if n == 2 else CHECKS4
        results = launch(world_checks, make_mesh(devices=["cpu"] * n), n, checks, timeout=WORLD_TIMEOUT_S,
                         threads=1)
        with open(path + ".tmp", "wb") as f:
            pickle.dump(results, f)
        os.replace(path + ".tmp", path)
        # the launching process removes them when it exits (a worker that
        # asks later then launches its own world)
        for leftover in (path, path + ".lock"):
            atexit.register(lambda p=leftover: os.path.exists(p) and os.remove(p))
        return results


def stage_grads(results, name):
    """The whole gradient of a pipeline check: the stages' gradients joined."""
    out = {}
    for r in results:
        out.update(r[name]["grads"])
    return out
