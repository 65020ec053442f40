"""The port's evaluation entry points (``cli.py`` ``eval``, ``extract-style``,
``stream``, ``autofocus``, ``train --mat-root``) against the JAX package's.

* ``eval --cpu`` on ``checkpoints/fast``, both CLIs in process with the same
  weights (the port's ``torch_weights.npz``, the JAX package's orbax
  ``release/``): the printed lines word for word, their numbers within one
  unit of the last printed digit (a value on a rounding boundary prints
  either way); the metrics of ``--json`` and ``metrics.jsonl`` with the
  same keys, PSNR within 2e-5 dB (every batch), R² within 1e-6, distances
  within 0.01 µm; the 100 montages within one grey level on at most 0.1 %
  of their pixels; the box plot written.
* ``eval --mat-root`` on the committed RBC fixture (64^2 centre crop, batch
  4: the last batch padded) with the ``rbc`` release's weights, under
  ``--domain red_blood_cell`` and its alias ``rbc``, against the JAX
  package's ``evaluate_mat_tree``: PSNR within 0.005 dB a batch,
  distances within 0.5 µm, the same counts; ``evaluate_mat_tree`` with 2
  refine steps alike, and with ``refine_distance`` the PSNR alike and the
  refined distances within the distance stage's reach (ROADMAP C.4).
* The measured-tree chain on the port alone, at 64^2 over the fixture:
  ``train --mat-root`` (2 steps, the supervised term forced off) ->
  ``extract-style --mat-root`` from its snapshot -> ``eval --mat-root`` and
  ``stream --root`` from the same snapshot.
* ``autofocus --input`` against the JAX package's command on four golden
  holograms.
* argparse: the new flags are taken (the device mesh's too: ``train
  --devices/--partition/--model-devices``, ``stream --devices``, ``serve
  --devices``); every flag and command still refused exits with code 2; the
  JAX package's errors of the mesh flags; ``train --devices N`` launches
  its world with no deadline for the run; ``train --cpu --devices 2
  --partition zero1`` on two CPU ranks; no card and no ``--cpu`` raises.
* ``utils/profiling.py``: ``trace`` writes a Chrome trace holding an
  ``annotate`` region; ``timeit`` returns its rate.
"""

import contextlib
import glob
import io
import json
import os
import re

import numpy as np
import pytest
from PIL import Image
from torch_cpu_threads import warm_few_torch_threads  # noqa: F401

from style_transfer_based_holographic_imaging_tpu import cli as jcli
from style_transfer_based_holographic_imaging_tpu.config import DOMAIN_PRESETS as J_PRESETS
from style_transfer_based_holographic_imaging_tpu.pipelines.mat_eval import (
    evaluate_mat_tree as j_evaluate_mat_tree,
)
from style_transfer_based_holographic_imaging_tpu_torch import cli
from style_transfer_based_holographic_imaging_tpu_torch.config import DOMAIN_PRESETS
from style_transfer_based_holographic_imaging_tpu_torch.interop import convert_params, load_style_vector
from style_transfer_based_holographic_imaging_tpu_torch.models import StyleTransferNet
from style_transfer_based_holographic_imaging_tpu_torch.pipelines import evaluate_mat_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST = os.path.join(REPO, "checkpoints", "fast")
TREE = os.path.join(REPO, "tests", "fixtures", "rbc_mat_tree", "red_blood_cell")
RBC_STYLE = os.path.join(REPO, "checkpoints", "rbc_style_vector.npz")
DB_TOL = 2e-5
R2_TOL = 1e-6
UM_TOL = 0.01
GREY_LEVELS = 1
GREY_SHARE = 1e-3
MAT_DB_TOL = 0.005
MAT_UM_TOL = 0.5
WORLD_TIMEOUT_S = 300.0
_NUM = re.compile(r"-?\d+\.\d+(?:e-?\d+)?")


def run(main, argv):
    """``main(argv)`` in process: (return value, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _orbax(path):
    import orbax.checkpoint as ocp

    return ocp.StandardCheckpointer().restore(path)["params"]


@pytest.fixture(scope="module")
def fast_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("eval")
    common = ["eval", "--cpu", "--save-dir", str(tmp), "--json"]
    port = run(cli.main, common + ["--checkpoint", FAST, "--exp-name", "port"])
    # The JAX command's loader first draws a random init it then replaces
    # (about 20 s on this CPU): hand it the restored release directly.
    release = os.path.join(FAST, "release")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcli, "_load_params", lambda args: _orbax(release))
        want = run(jcli.main, common + ["--checkpoint", release, "--exp-name", "jax"])
    return port, want, tmp / "port", tmp / "jax"


def _jsonl(path):
    with open(path) as f:
        lines = f.read().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


def test_eval_prints_the_jax_lines(fast_runs):
    (rc, out, _), (jrc, jout, _), _, _ = fast_runs
    assert rc == jrc == 0
    lines, jlines = out.splitlines(), jout.splitlines()
    assert len(lines) == len(jlines) == 5
    for got, want in zip(lines[:-1], jlines[:-1]):
        assert _NUM.sub("#", got) == _NUM.sub("#", want)
        for g, w in zip(_NUM.findall(got), _NUM.findall(want)):
            decimals = len(w.split(".")[1])
            assert abs(float(g) - float(w)) <= 1.01 * 10.0 ** -decimals, (got, want)
    got, want = json.loads(lines[-1]), json.loads(jlines[-1])
    assert got.keys() == want.keys()
    for k in ("mean_psnr", "heldout_mean_psnr"):
        assert abs(got[k] - want[k]) < DB_TOL, k
    for k in ("r2", "heldout_r2"):
        assert abs(got[k] - want[k]) < R2_TOL, k
    assert got["distance_outlier_batches"] == want["distance_outlier_batches"]


def test_eval_metrics_jsonl_matches_jax(fast_runs):
    _, _, port_dir, jax_dir = fast_runs
    got, want = _jsonl(port_dir / "metrics.jsonl"), _jsonl(jax_dir / "metrics.jsonl")
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["psnr_per_batch"], want["psnr_per_batch"], rtol=0, atol=DB_TOL)
    np.testing.assert_allclose(got["mae_per_batch"], want["mae_per_batch"], rtol=1e-5)
    np.testing.assert_allclose(got["distance_true_um"], want["distance_true_um"], rtol=0, atol=UM_TOL)
    np.testing.assert_allclose(got["distance_pred_um"], want["distance_pred_um"], rtol=0, atol=UM_TOL)
    for k in ("mean_psnr", "heldout_mean_psnr"):
        assert abs(got[k] - want[k]) < DB_TOL, k
    for k in ("r2", "heldout_r2"):
        assert abs(got[k] - want[k]) < R2_TOL, k


def test_eval_montages_and_boxplot_match_jax(fast_runs):
    _, _, port_dir, jax_dir = fast_runs
    names = sorted(os.path.basename(p) for p in glob.glob(str(jax_dir / "*_test.png")))
    assert len(names) == 100
    assert sorted(os.path.basename(p) for p in glob.glob(str(port_dir / "*_test.png"))) == names
    off, total = 0, 0
    for name in names:
        got = np.asarray(Image.open(port_dir / name), np.int16)
        want = np.asarray(Image.open(jax_dir / name), np.int16)
        assert got.shape == want.shape == (256, 512)
        diff = np.abs(got - want)
        assert diff.max() <= GREY_LEVELS, name
        off += int((diff > 0).sum())
        total += diff.size
    assert off <= GREY_SHARE * total, f"{off} of {total} pixels differ"
    assert os.path.getsize(port_dir / "distance_prediction.png") > 1000


@pytest.fixture(scope="module")
def rbc_release(tmp_path_factory):
    """The rbc release as the port reads it (``torch_weights.npz`` in a
    checkpoint directory) and as the JAX package does (its params)."""
    params = _orbax(os.path.join(REPO, "checkpoints", "rbc_release"))
    ckpt = tmp_path_factory.mktemp("rbc") / "ckpt"
    ckpt.mkdir()
    np.savez(ckpt / "torch_weights.npz", **{k: v.numpy() for k, v in convert_params(params).items()})
    return params, str(ckpt)


def _mat_cfgs(size, **data_kw):
    import dataclasses

    jcfg, cfg = J_PRESETS["red_blood_cell"](), DOMAIN_PRESETS["red_blood_cell"]()
    return (dataclasses.replace(jcfg, data=dataclasses.replace(jcfg.data, image_size=size, **data_kw)),
            dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, image_size=size, **data_kw)))


def _compare_mat(got, want):
    for k in ("n_samples", "n_gt_scored", "measured_eval"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["psnr_per_batch"], want["psnr_per_batch"], rtol=0, atol=MAT_DB_TOL)
    np.testing.assert_allclose(got["distance_true_um"], want["distance_true_um"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["distance_pred_um"], want["distance_pred_um"], rtol=0, atol=MAT_UM_TOL)


@pytest.fixture(scope="module")
def jax_mat_eval(rbc_release):
    """The JAX package's ``evaluate_mat_tree`` of the fixture at 64^2, batch 4."""
    jcfg, _ = _mat_cfgs(64)
    return j_evaluate_mat_tree(rbc_release[0], TREE, jcfg, load_style_vector(RBC_STYLE),
                               domain="red_blood_cell", batch_size=4)


# red_blood_cell and its preset alias rbc read the same layout
@pytest.mark.parametrize("domain", ["red_blood_cell", "rbc"])
def test_eval_mat_root_matches_jax(rbc_release, jax_mat_eval, tmp_path, domain):
    _, ckpt = rbc_release
    rc, out, err = run(cli.main, ["eval", "--cpu", "--mat-root", TREE, "--domain", domain,
                                  "--image-size", "64", "--checkpoint", ckpt, "--style-vector", RBC_STYLE,
                                  "--batch-size", "4", "--save-dir", str(tmp_path), "--exp-name", "mat",
                                  "--json"])
    assert rc == 0 and "loaded weights" in err
    with open(tmp_path / "mat" / "mat_eval_metrics.json") as f:
        got = json.load(f)
    want = jax_mat_eval
    assert set(got) == set(want)
    assert got["n_samples"] == 9 and len(got["psnr_per_batch"]) == 3
    _compare_mat(got, want)
    assert out.splitlines()[-2] == "Samples: 9 (9 GT-scored)"
    assert json.loads(out.splitlines()[-1]).keys() == {"mean_psnr", "mean_mae", "r2", "n_samples",
                                                       "n_gt_scored"}


def test_mat_tree_refined_matches_jax(rbc_release):
    params, _ = rbc_release
    # two of the tree's three test distances
    jcfg, cfg = _mat_cfgs(64, content_distances=(4.0, 8.0))
    style = load_style_vector(RBC_STYLE)
    net = StyleTransferNet.from_state_dict(convert_params(params), 1.0)
    kw = dict(domain="red_blood_cell", batch_size=5, refine_steps=2)
    got = evaluate_mat_tree(net, TREE, cfg, style, device="cpu", **kw)
    want = j_evaluate_mat_tree(params, TREE, jcfg, style, **kw)
    assert got["n_samples"] == 6 and len(got["psnr_per_batch"]) == 2
    _compare_mat(got, want)
    # With refine_distance a first stage moves the distance alone, 10 Adam
    # steps of 0.1 lr: each about 0.1 lr in a direction that a near-zero
    # gradient's fp32 rounding can decide (ROADMAP C.4), so the refined
    # distances are held to that stage's reach, 10 x 0.1 lr in network units
    # (500 µm here); the phase's PSNR to the same 0.005 dB.
    moved = evaluate_mat_tree(net, TREE, cfg, style, device="cpu", refine_distance=True, **kw)
    want = j_evaluate_mat_tree(params, TREE, jcfg, style, refine_distance=True, **kw)
    np.testing.assert_allclose(moved["psnr_per_batch"], want["psnr_per_batch"], rtol=0, atol=MAT_DB_TOL)
    reach = 10 * 0.1 * 0.05 * cfg.physics.distance_normalize * 1000.0
    np.testing.assert_allclose(moved["distance_pred_um"], want["distance_pred_um"], rtol=0, atol=reach)
    assert np.abs(np.subtract(moved["distance_pred_um"], got["distance_pred_um"])).max() > 1.0


def test_measured_tree_chain(tmp_path):
    run_dir, sv, out_dir = str(tmp_path / "run"), str(tmp_path / "sv.npz"), str(tmp_path / "out")
    rc, _, err = run(cli.main, ["train", "--cpu", "--mat-root", TREE, "--domain", "red_blood_cell",
                                "--iterations", "2", "--batch-size", "2", "--image-size", "64",
                                "--checkpoint-every", "2", "--checkpoint-dir", run_dir, "--log-every", "1"])
    assert rc == 0 and "forcing supervised_weight=0" in err
    assert "measured train tree: 15 frames" in err
    assert os.path.isfile(os.path.join(run_dir, "iter_2", "state.pt"))
    with open(os.path.join(run_dir, "train_metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    assert [r["step"] for r in logged] == [1, 2] and "loss_supervised" not in logged[0]

    rc, out, err = run(cli.main, ["extract-style", "--cpu", "--mat-root", TREE, "--domain",
                                  "red_blood_cell", "--image-size", "64", "--checkpoint", run_dir,
                                  "--n-batches", "2", "--out", sv])
    assert rc == 0 and "iter_2" in err and out.strip() == f"style vector written to {sv}"
    mean, std = load_style_vector(sv)
    assert mean.shape == std.shape == (1, 1, 1, 512) and np.isfinite(mean).all() and (std > 0).all()

    rc, out, err = run(cli.main, ["eval", "--cpu", "--mat-root", TREE, "--domain", "red_blood_cell",
                                  "--image-size", "64", "--checkpoint", run_dir, "--style-vector", sv,
                                  "--batch-size", "4", "--save-dir", out_dir, "--exp-name", "mat",
                                  "--json"])
    assert rc == 0 and "iter_2" in err
    with open(os.path.join(out_dir, "mat", "mat_eval_metrics.json")) as f:
        m = json.load(f)
    assert m["measured_eval"] and m["n_gt_scored"] == 9
    assert np.isfinite(m["mean_psnr"]) and np.isfinite(m["r2"])

    rc, out, err = run(cli.main, ["stream", "--cpu", "--root", TREE, "--domain", "red_blood_cell",
                                  "--checkpoint", run_dir, "--style-vector", sv, "--batch-size", "4"])
    assert rc == 0 and "streaming 9 frames" in err
    line = json.loads(out.splitlines()[-1])
    assert line["frames"] == 9 and line["value"] > 0 and line["unit"] == "frames/sec/chip"


def test_autofocus_matches_jax(tmp_path):
    from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite

    g = load_golden_suite()
    path = str(tmp_path / "holo.npz")
    np.savez(path, holo=g.content_holo[3, :4, 0])
    argv = ["autofocus", "--cpu", "--input", path, "--d-min", "0.2", "--d-max", "1.0",
            "--n-coarse", "9", "--n-fine", "5", "--batch-size", "2", "--print-distances"]
    rc, out, _ = run(cli.main, argv)
    jrc, jout, _ = run(jcli.main, argv)
    assert rc == jrc == 0
    got, want = out.splitlines(), jout.splitlines()
    assert json.loads(got[0]).keys() == json.loads(want[0]).keys()
    np.testing.assert_allclose([float(v) for v in got[1:]], [float(v) for v in want[1:]], atol=1e-4)


NEW_FLAGS = [
    ["eval", "--save-dir", "", "--exp-name", "x", "--json", "--profile", "p", "--refine", "3",
     "--refine-distance", "--quant", "--mat-root", "t", "--domain", "rbc", "--batch-size", "8"],
    ["eval", "--domain", "polystyrene_bead", "--quant", "s.json"],
    ["train", "--domain", "tissue", "--bank", "bead", "--mat-root", "t"],
    ["train", "--bank", "rbc"],
    ["extract-style", "--bank", "rbc", "--domain", "red_blood_cell", "--mat-root", "t", "--n-batches", "2",
     "--out", "o.npz"],
    ["stream", "--root", "r", "--domain", "red_blood_cell", "--image-set", "train", "--distances", "4,5",
     "--style-distance", "6", "--batch-size", "4", "--refine", "2", "--devices", "1", "--quant"],
    ["autofocus", "--golden", "--domain", "rbc", "--d-min", "0.3", "--d-max", "0.9", "--n-coarse", "5",
     "--n-fine", "3", "--metric", "grad", "--batch-size", "10", "--print-distances",
     "--asm-backend", "torch"],
    ["export", "--out", "m.hstx", "--batch-size", "4", "--bf16", "--platforms", "cpu",
     "--style-distance", "0.2", "--check", "--quant", "--asm-backend", "cuda"],
    ["serve", "--artifact", "model.hstx", "--batch-size", "4"],
    ["sweep", "--style-distances", "0.2,0.6", "--save-dir", "s", "--seed", "3"],
    ["synth-bench", "--batch-size", "8"],
    ["doctor", "--cpu"],
    ["train", "--dtype", "bfloat16"],
    ["train", "--tensorboard-dir", "tb"],
    ["train", "--devices", "2"],
    ["train", "--partition", "zero1"],
    ["train", "--model-devices", "2"],
    ["stream", "--devices", "2", "--root", "r"],
    ["serve", "--devices", "2"],
]
REFUSED = [
    ["extract-style", "--pt-out", "sv.pt"],
    ["eval", "--domain", "mars"],
    ["extract-style", "--bank", "golden"],
]


@pytest.mark.parametrize("argv", NEW_FLAGS, ids=lambda a: " ".join(a[:2]))
def test_new_flags_are_taken(argv):
    args = cli.build_parser().parse_args(argv)
    assert args.fn.__name__ == "cmd_" + argv[0].replace("-", "_")


@pytest.mark.parametrize("argv", REFUSED, ids=lambda a: " ".join(a))
def test_unported_flags_exit_2(argv):
    with pytest.raises(SystemExit) as e, contextlib.redirect_stderr(io.StringIO()):
        cli.main(argv)
    assert e.value.code == 2


@pytest.mark.parametrize("argv, message", [
    (["train", "--cpu", "--partition", "zero1"], "--partition zero1 needs --devices N (N >= 2)"),
    (["train", "--cpu", "--devices", "3", "--partition", "tp", "--model-devices", "2"],
     "--devices 3 must divide by --model-devices 2"),
    (["serve", "--cpu", "--artifact", "model.hstx", "--devices", "2"],
     "--artifact serving is single-device"),
], ids=["partition without devices", "indivisible model devices", "artifact on a mesh"])
def test_mesh_flag_errors_are_the_jax_packages(argv, message):
    """The JAX package's own checks of the mesh flags: exit status 1 and its
    message, before any work starts."""
    rc, _, err = run(cli.main, argv)
    assert rc == 1 and message in err


def test_cli_train_sets_no_deadline_on_the_run(monkeypatch):
    """``train --devices N`` launches its world with no deadline for the
    whole run (``timeout=None``): a schedule of any length runs to its end,
    each collective keeping its own time limit."""
    from style_transfer_based_holographic_imaging_tpu_torch import parallel

    calls = []
    monkeypatch.setattr(parallel, "launch", lambda fn, mesh, *a, **kw: calls.append((mesh, kw)) or [0])
    rc, _, _ = run(cli.main, ["train", "--cpu", "--devices", "2", "--partition", "zero1"])
    assert rc == 0 and len(calls) == 1
    mesh, kw = calls[0]
    assert mesh.size == 2 and kw == {"timeout": None}


def test_cli_train_on_two_cpu_ranks(tmp_path, monkeypatch):
    """``train --cpu --devices 2 --partition zero1``: two gloo ranks on the
    CPU (``parallel.launch``) train two steps; rank 0 alone writes the
    metrics, a snapshot a step and the final checkpoint. The test gives the
    world a deadline the command does not, so that a hung collective fails
    it within the run."""
    from style_transfer_based_holographic_imaging_tpu_torch import parallel

    launch = parallel.launch
    monkeypatch.setattr(parallel, "launch",
                        lambda *a, **kw: launch(*a, **{**kw, "timeout": WORLD_TIMEOUT_S}))
    ckpt = tmp_path / "run"
    rc, _, _ = run(cli.main, ["train", "--cpu", "--devices", "2", "--partition", "zero1",
                              "--iterations", "2", "--batch-size", "2", "--bank", "golden",
                              "--checkpoint-dir", str(ckpt), "--log-every", "1",
                              "--checkpoint-every", "1"])
    assert rc == 0
    rows = [json.loads(line) for line in open(ckpt / "train_metrics.jsonl")]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    assert sorted(os.listdir(ckpt)) == ["iter_1", "iter_2", "train_metrics.jsonl"]


@pytest.mark.parametrize("argv", [["eval"], ["extract-style"], ["stream", "--root", TREE],
                                  ["autofocus", "--golden"], ["export"], ["sweep"], ["synth-bench"],
                                  ["serve", "--artifact", "model.hstx"]])
def test_no_card_without_cpu_raises(argv, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        cli.main(argv)


def test_profiling_trace_annotate_and_timeit(tmp_path):
    import torch

    from style_transfer_based_holographic_imaging_tpu_torch.utils.profiling import annotate, timeit, trace

    x = torch.ones(64, 64)
    with trace(str(tmp_path)):
        with annotate("chip_region"):
            (x @ x).sum()
    with open(tmp_path / "trace.json") as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert "chip_region" in names
    t = timeit(lambda: x @ x, iters=3, warmup=1, trials=2)
    assert t["sec_per_call"] > 0 and t["calls_per_sec"] == pytest.approx(1.0 / t["sec_per_call"])
