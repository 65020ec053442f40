"""The port's last commands (``cli.py`` ``export``, ``serve --artifact``,
``sweep``, ``synth-bench``, ``doctor``) and the modules under them
(``pipelines/stylize.py``, ``data/synth.synth_interpolation_batch``),
on the CPU, against the JAX package's.

* ``stylize`` at width 1.0 (the JAX function builds a default-width net) on
  32^2 inputs: amplitude and phase within 1e-4 of max of the JAX function's
  on the same seeded weights.
* ``synth_interpolation_batch`` keyed by ``utils/jax_random.py``: the digit
  and the content distance the JAX function draws from the same seed (the
  phase objects and the distances equal), the holograms within 1e-5 of max.
* On a seeded width-0.25 release directory (``torch_weights.npz``,
  ``config.json``, ``style_vector.npz``): ``export --platforms cpu --check``
  at the suite's batch prints ``eval``'s metrics, rounded as the JAX
  command rounds them; ``serve --artifact`` refuses what the JAX command
  refuses; ``sweep`` writes ``interpolation_sweep.png``, one 128^2 row of
  four planes a style distance; ``synth-bench`` prints its one JSON line.
* ``doctor --cpu`` prints the JAX doctor's inventory: its ``releases``
  equal the JAX command's but for the added ``torch_weights`` key; without
  a card and without ``--cpu`` it says so and exits 0.
"""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch_cpu_threads import warm_few_torch_threads  # noqa: F401
from torch_seeded import seeded_net, seeded_params, seeded_style

from style_transfer_based_holographic_imaging_tpu import cli as jcli
from style_transfer_based_holographic_imaging_tpu.config import DataConfig as JDataConfig
from style_transfer_based_holographic_imaging_tpu.config import PhysicsConfig as JPhysicsConfig
from style_transfer_based_holographic_imaging_tpu.data import load_golden_suite as j_load_goldens
from style_transfer_based_holographic_imaging_tpu.data.synth import golden_digit_bank as j_golden_bank
from style_transfer_based_holographic_imaging_tpu.data.synth import (
    synth_interpolation_batch as j_interpolation_batch,
)
from style_transfer_based_holographic_imaging_tpu.pipelines.stylize import stylize as j_stylize
from style_transfer_based_holographic_imaging_tpu_torch import ExperimentConfig, ModelConfig, cli
from style_transfer_based_holographic_imaging_tpu_torch.config import DataConfig, PhysicsConfig
from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite, synth
from style_transfer_based_holographic_imaging_tpu_torch.pipelines import stylize
from style_transfer_based_holographic_imaging_tpu_torch.utils import jax_random

WIDTH = 0.25
DISTANCES = (0.2, 0.4, 0.6, 0.8)


def run(main, argv):
    """``main(argv)`` in process: (return value, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def test_stylize_matches_jax():
    params = seeded_params(1.0, 32)
    net = seeded_net(params, 1.0)
    rng = np.random.default_rng(4)
    content, style = (rng.random((2, 1, 32, 32), np.float32) for _ in range(2))
    for alpha in (1.0, 0.6):
        got = stylize(net, content, style, alpha)
        want = j_stylize(params, jnp.asarray(content), jnp.asarray(style), alpha)
        assert set(got) == set(want) == {"amp", "phase"}
        for k in want:
            assert got[k].shape == want[k].shape
            assert _rel(got[k].numpy(), want[k]) < 1e-4, (alpha, k)


@pytest.mark.parametrize("seed", [0, 5])
def test_synth_interpolation_batch_matches_jax(seed):
    want = j_interpolation_batch(jax.random.key(seed), jnp.asarray(j_golden_bank(j_load_goldens())),
                                 data=JDataConfig(style_distances=DISTANCES), physics=JPhysicsConfig())
    bank = torch.from_numpy(synth.golden_digit_bank(load_golden_suite()))
    got = synth.synth_interpolation_batch(jax_random.key(seed), bank,
                                          data=DataConfig(style_distances=DISTANCES),
                                          physics=PhysicsConfig())
    assert set(got) == set(want)
    for k in ("phase_content", "distance_style", "distance_content", "amplitude"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    for k in ("style_holo", "content_holo"):
        assert got[k].shape == (len(DISTANCES), 1, 128, 128)
        assert _rel(got[k].numpy(), want[k]) < 1e-5, k


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    """A seeded width-0.25 release directory the port's CLI loads."""
    root = tmp_path_factory.mktemp("release")
    net = seeded_net(seeded_params(WIDTH, 128), WIDTH)
    np.savez(root / "torch_weights.npz", **{k: v.numpy() for k, v in net.state_dict().items()})
    with open(root / "config.json", "w") as f:
        f.write(ExperimentConfig(model=ModelConfig(width=WIDTH)).to_json())
    mean, std = seeded_style(net.encoder.out_channels)
    np.savez(root / "style_vector.npz", mean=mean, std=std)
    return str(root)


def test_export_check_prints_the_eval_metrics(release, tmp_path):
    rc, out, _ = run(cli.main, ["eval", "--cpu", "--checkpoint", release, "--save-dir", "", "--json"])
    assert rc == 0
    metrics = json.loads(out.splitlines()[-1])
    path = str(tmp_path / "model.hstx")
    rc, out, _ = run(cli.main, ["export", "--cpu", "--checkpoint", release, "--platforms", "cpu",
                                "--batch-size", "5", "--out", path, "--check"])
    assert rc == 0
    wrote, checked = out.splitlines()
    summary = json.loads(wrote.split("  ", 1)[1])
    assert wrote.startswith(f"wrote {path}") and summary["bytes"] == os.path.getsize(path)
    assert summary["platforms"] == ["cpu"] and summary["asm_backend"] == "torch"
    assert summary["width"] == WIDTH and summary["batch_size"] == 5
    assert json.loads(checked) == {k: round(metrics[k], 4) for k in ("mean_psnr", "mean_mae", "r2")}


@pytest.mark.parametrize("extra", [["--refine", "2"], ["--quant"], ["--checkpoint", "c"],
                                   ["--style-vector", "s.npz"]], ids=lambda e: e[0])
def test_serve_artifact_refuses_what_jax_refuses(extra):
    rc, _, err = run(cli.main, ["serve", "--cpu", "--artifact", "model.hstx", *extra])
    assert rc == 1 and "--artifact" in err


def test_sweep_writes_its_montage(release, tmp_path):
    rc, out, _ = run(cli.main, ["sweep", "--cpu", "--checkpoint", release, "--save-dir", str(tmp_path)])
    path = os.path.join(tmp_path, "interpolation_sweep.png")
    assert rc == 0 and out.strip() == f"sweep montage ({len(DISTANCES)} planes): {path}"
    img = np.asarray(Image.open(path))
    assert img.shape == (128 * len(DISTANCES), 128 * 4) and img.dtype == np.uint8


def test_synth_bench_prints_its_line():
    rc, out, _ = run(cli.main, ["synth-bench", "--cpu", "--batch-size", "4"])
    line = json.loads(out.splitlines()[-1])
    assert rc == 0 and line["metric"] == "hologram synthesis (distance sweep)"
    assert line["unit"] == "holograms/sec/chip" and line["value"] > 0


def test_doctor_prints_the_jax_inventory():
    rc, out, _ = run(cli.main, ["doctor", "--cpu"])
    jrc, jout, _ = run(jcli.main, ["doctor", "--cpu"])
    assert rc == jrc == 0
    got, want = json.loads(out), json.loads(jout)
    assert got["devices"] == ["cpu"] and got["scanned"] == want["scanned"]
    assert got["native_libs"] == want["native_libs"] and "libs" in got["kernel_build"]
    assert set(got["releases"]) == set(want["releases"])
    assert got["releases"]["fast"]["torch_weights"] is True  # checkpoints/fast/torch_weights.npz
    for name, rel in got["releases"].items():
        assert isinstance(rel.pop("torch_weights"), bool)
        assert rel == want["releases"][name], name


def test_doctor_without_a_card_says_so(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, _ = run(cli.main, ["doctor"])
    report = json.loads(out)
    assert rc == 0 and "no CUDA card" in report["devices"] and report["releases"]
