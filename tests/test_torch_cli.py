"""The port's CLI (``cli.py``): ``serve`` and its helpers.

* The loaders find the run config, the style vector and the int8 scales in
  the JAX package's order (``cli._load_config``, ``_load_style``,
  ``_load_quant_scales``) on the same ``tmp_path`` trees: a release
  directory holding its files, the canonical ``release`` beside its
  parent's, a domain ``rbc_release`` with ``rbc_*`` siblings, and a
  directory whose files shadow its parent's. ``torch_weights.npz`` is read
  from the checkpoint directory first, then from its parent.
* ``--asm-backend`` sets the process-wide propagator backend; an unknown
  name is refused.
* No fallback hides the card: ``serve`` without ``--cpu`` and without a card
  raises, and so does a checkpoint directory that holds orbax weights and no
  numpy file.
* ``python -m ...cli serve --cpu --checkpoint checkpoints/fast --port 0``
  answers a request as the same service does in process, bit for bit.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from torch_cpu_threads import warm_torch_threads  # noqa: F401

from style_transfer_based_holographic_imaging_tpu import cli as jcli
from style_transfer_based_holographic_imaging_tpu_torch import ExperimentConfig, cli
from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite
from style_transfer_based_holographic_imaging_tpu_torch.interop import (
    load_release_weights,
    load_style_vector,
)
from style_transfer_based_holographic_imaging_tpu_torch.models import StyleTransferNet
from style_transfer_based_holographic_imaging_tpu_torch.ops import asm
from style_transfer_based_holographic_imaging_tpu_torch.pipelines import (
    RetrievalService,
    retrieve_remote,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST = os.path.join(REPO, "checkpoints", "fast")


def _put(root, rel, tag):
    """A config, style vector or scales file at ``root/rel``, marked ``tag``."""
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if rel.endswith("config.json"):
        with open(path, "w") as f:
            json.dump({"model": {"width": tag}, "physics": {"pixel_size": 1e-6 * tag}}, f)
    elif rel.endswith("style_vector.npz"):
        np.savez(path, mean=np.full((1, 1, 1, 4), tag, np.float32), std=np.ones((1, 1, 1, 4), np.float32))
    else:
        with open(path, "w") as f:
            json.dump({"encoder.conv1_1": float(tag)}, f)


# (files under tmp_path with their tags, the --checkpoint under tmp_path)
LAYOUTS = {
    "release_dir": ({"rel/config.json": 1, "rel/style_vector.npz": 1, "rel/quant_scales.json": 1}, "rel"),
    "canonical_release": ({"config.json": 2, "style_vector.npz": 2, "quant_scales.json": 2,
                           "release/x": 0}, "release"),
    "domain_release": ({"rbc_config.json": 3, "rbc_style_vector.npz": 3, "rbc_quant_scales.json": 3,
                        "config.json": 9, "style_vector.npz": 9, "quant_scales.json": 9,
                        "rbc_release/x": 0}, "rbc_release"),
    "dir_shadows_parent": ({"fast/config.json": 4, "fast/style_vector.npz": 4,
                            "fast/quant_scales.json": 4, "config.json": 8, "style_vector.npz": 8,
                            "quant_scales.json": 8}, "fast"),
    "parent_only": ({"style_vector.npz": 5, "quant_scales.json": 5, "fast/x": 0}, "fast"),
}


def _args(**kw):
    base = dict(checkpoint=None, style_vector=None, cpu=True, image_size=128, asm_backend="auto",
                quant=None)
    return argparse.Namespace(**{**base, **kw})


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_loaders_search_as_the_jax_package_does(tmp_path, layout):
    files, ckpt = LAYOUTS[layout]
    for rel, tag in files.items():
        if rel.endswith("/x"):
            os.makedirs(tmp_path / os.path.dirname(rel), exist_ok=True)
        else:
            _put(str(tmp_path), rel, tag)
    args = _args(checkpoint=str(tmp_path / ckpt), quant="auto")
    got_cfg, ref_cfg = cli._load_config(args), jcli._load_config(args)
    assert (got_cfg is None) == (ref_cfg is None)
    if ref_cfg is not None:
        assert got_cfg.model.width == ref_cfg.model.width
        assert got_cfg.physics.pixel_size == ref_cfg.physics.pixel_size
    got_style, ref_style = cli._load_style(args), jcli._load_style(args)
    assert all(np.array_equal(g, r) for g, r in zip(got_style, ref_style))
    assert cli._load_quant_scales(args) == jcli._load_quant_scales(args)


@pytest.mark.parametrize("where", ["dir", "parent"])
def test_weights_come_from_the_directory_then_its_parent(tmp_path, where):
    state = {"w": torch.arange(3, dtype=torch.float32)}
    other = {"w": torch.zeros(3)}
    os.makedirs(tmp_path / "rel")
    np.savez(tmp_path / "torch_weights.npz", **{k: v.numpy() for k, v in state.items()})
    if where == "dir":
        state, other = other, state
        np.savez(tmp_path / "rel" / "torch_weights.npz", **{k: v.numpy() for k, v in state.items()})
    got = cli._load_params(_args(checkpoint=str(tmp_path / "rel")))
    assert torch.equal(got["w"], state["w"])


def test_an_orbax_only_checkpoint_raises(tmp_path):
    """An orbax directory without its ``manifest.ocdbt`` holds nothing the
    port reads (a whole release loads: tests/test_torch_orbax.py)."""
    rel = tmp_path / "ultra" / "release"
    os.makedirs(rel / "d")
    (rel / "_METADATA").write_text("{}")
    for ckpt in (rel, tmp_path / "ultra"):
        with pytest.raises(FileNotFoundError, match="no manifest.ocdbt"):
            cli._load_params(_args(checkpoint=str(ckpt)))


def test_no_checkpoint_at_all_gives_the_random_init(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    state = cli._load_params(_args())
    assert "no checkpoint found; using random init" in capsys.readouterr().err
    StyleTransferNet.from_state_dict(state, 1.0)
    assert all(torch.equal(v, cli._load_params(_args())[k]) for k, v in state.items())


@pytest.mark.parametrize("name", ["torch", "cuda", "auto"])
def test_asm_backend_option_sets_the_global(name):
    try:
        device = cli._setup_backend(_args(asm_backend=name))
        assert device == torch.device("cpu") and asm._BACKEND == name
    finally:
        asm.set_asm_backend("auto")


def test_an_unknown_asm_backend_is_refused():
    with pytest.raises(SystemExit):
        cli.main(["serve", "--cpu", "--asm-backend", "xla"])
    with pytest.raises(ValueError):
        asm.set_asm_backend("pallas")


def test_serve_without_cpu_and_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        with pytest.raises(RuntimeError, match="--cpu"):
            cli.main(["serve", "--checkpoint", FAST])
    finally:
        asm.set_asm_backend("auto")


def test_serve_cpu_answers_as_the_service_does():
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.Popen(
        [sys.executable, "-m", "style_transfer_based_holographic_imaging_tpu_torch.cli", "serve",
         "--cpu", "--checkpoint", "checkpoints/fast", "--port", "0", "--batch-size", "2"],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        deadline, line = time.monotonic() + 120, ""
        while "serving on" not in line:
            assert time.monotonic() < deadline and proc.poll() is None, "serve did not start"
            line = proc.stderr.readline()
        url, health = line.split()[2], json.loads(line.split(None, 3)[3])
        assert health["batch_size"] == 2 and health["device"] == "cpu" and health["width"] == 0.5
        holo = load_golden_suite().content_holo[3]
        got = retrieve_remote(url, holo)
    finally:
        proc.terminate()
        proc.wait(30)
    with open(os.path.join(FAST, "config.json")) as f:
        cfg = ExperimentConfig.from_json(f.read())
    service = RetrievalService(
        StyleTransferNet.from_state_dict(load_release_weights(os.path.join(FAST, "torch_weights.npz")), 0.5),
        load_style_vector(os.path.join(FAST, "style_vector.npz")), cfg, batch_size=2,
        dtype=torch.bfloat16, device="cpu")
    service.warmup()  # as cmd_serve does before its first request
    want = service.retrieve(holo)
    assert all(np.array_equal(got[k], want[k]) for k in want)
