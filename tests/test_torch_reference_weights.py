"""The reference's torch checkpoints in the port (``interop/torch_weights.py``)
against the JAX package's converters, on reference-layout files written from
numpy seeds (``nn.Sequential`` indices, an RGB stem, full width):

* ``load_reference_checkpoint`` equals ``convert_params`` of the JAX
  package's ``convert_vgg/decoder/distance_state_dict`` output bit for bit,
  with and without ``decoder_ph``; a VGG file cut before conv4_1 takes
  conv4_1 from ``init_net_params``; with ``device`` the net holds the same
  state. The JAX converters are numpy only: no JAX
  init runs.
* The RGB stem is summed over its input channels; a shape the net does not
  take raises and names the layer.
* The ``.pt`` style vector both ways against the JAX reader and writer, and
  ``cli extract-style --pt-out`` (the ``.pt`` read back equal to the
  ``.npz``'s mean and std bit for bit, the JAX command's lines).
"""

import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

from style_transfer_based_holographic_imaging_tpu.interop import torch_weights as jtw
from style_transfer_based_holographic_imaging_tpu_torch import ExperimentConfig, cli
from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite, synth
from style_transfer_based_holographic_imaging_tpu_torch.interop import (
    convert_params,
    load_reference_checkpoint,
    load_style_vector,
    load_style_vector_pt,
    save_style_vector_pt,
)
from style_transfer_based_holographic_imaging_tpu_torch.interop import torch_weights as ptw
from style_transfer_based_holographic_imaging_tpu_torch.models import StyleTransferNet, init_net_params

# The reference's `net.vgg` up to relu4_1 and `net.decoder`: (index, C_out,
# C_in, k); the decoder's transposed convs are (C_in, C_out, 2, 2).
VGG = [(0, 3, 3, 1), (2, 64, 3, 3), (5, 64, 64, 3), (9, 128, 64, 3), (12, 128, 128, 3),
       (16, 256, 128, 3), (19, 256, 256, 3), (22, 256, 256, 3), (25, 256, 256, 3), (29, 512, 256, 3)]
DECODER = [(1, 512, 512, 3), (4, 256, 512, 3), (6, 256, 256, 2), (9, 256, 256, 3), (12, 256, 256, 3),
           (15, 256, 256, 3), (18, 128, 256, 3), (20, 128, 128, 2), (23, 128, 128, 3), (26, 64, 128, 3),
           (28, 64, 64, 2), (31, 64, 64, 3), (34, 64, 64, 3), (37, 2, 64, 3)]
DISTANCE = {"l1": (1024, 1024), "l2": (1024, 1024), "l3": (512, 1024), "out": (1, 512)}


def _conv_state(layers, rng, transposed=()):
    state = {}
    for idx, c_out, c_in, k in layers:
        shape = (c_in, c_out, k, k) if idx in transposed else (c_out, c_in, k, k)
        state[f"{idx}.weight"] = torch.from_numpy(
            (rng.standard_normal(shape) * np.sqrt(2.0 / (c_in * k * k))).astype(np.float32))
        state[f"{idx}.bias"] = torch.from_numpy((0.01 * rng.standard_normal(c_out)).astype(np.float32))
    return state


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The reference's files, written once: the VGG (its stem RGB, 3 -> 3
    channels) whole and cut before conv4_1, two decoders, the distance MLP."""
    rng = np.random.default_rng(0)
    states = {"vgg": _conv_state(VGG, rng), "decoder": _conv_state(DECODER, rng, transposed=(6, 20, 28)),
              "decoder_ph": _conv_state(DECODER, rng, transposed=(6, 20, 28)), "distance": {}}
    states["vgg_cut"] = {k: v for k, v in states["vgg"].items() if int(k.split(".")[0]) < 29}
    for name, shape in DISTANCE.items():
        states["distance"][f"{name}.weight"] = torch.from_numpy(
            (rng.standard_normal(shape) / np.sqrt(shape[1])).astype(np.float32))
        states["distance"][f"{name}.bias"] = torch.from_numpy((0.01 * rng.standard_normal(shape[0])).astype(np.float32))
    root = tmp_path_factory.mktemp("reference")
    paths = {}
    for name, state in states.items():
        paths[name] = str(root / f"{name}.pth")
        torch.save(state, paths[name])
    return paths


def jax_converted(vgg, decoder, distance, decoder_ph=None):
    tree = {
        "encoder": jtw.convert_vgg_state_dict(jtw.load_torch_tensor(vgg)),
        "decoder": jtw.convert_decoder_state_dict(jtw.load_torch_tensor(decoder)),
        "distance_g": jtw.convert_distance_state_dict(jtw.load_torch_tensor(distance)),
    }
    if decoder_ph is not None:
        tree["decoder_ph"] = jtw.convert_decoder_state_dict(jtw.load_torch_tensor(decoder_ph))
    return convert_params(tree)


@pytest.mark.parametrize("phase_decoder", [False, True], ids=["plain", "decoder_ph"])
def test_reference_checkpoint_equals_the_jax_conversion(files, phase_decoder):
    args = (files["vgg"], files["decoder"], files["distance"])
    ph = files["decoder_ph"] if phase_decoder else None
    got = load_reference_checkpoint(*args, decoder_ph=ph)
    want = jax_converted(*args, decoder_ph=ph)
    with torch.device("meta"):
        names = set(StyleTransferNet(with_phase_decoder=phase_decoder).state_dict())
    assert set(got) == set(want) == names
    for name, t in want.items():
        assert got[name].dtype == torch.float32 and torch.equal(got[name], t), name
    if not phase_decoder:
        net = load_reference_checkpoint(*args, device="cpu")
        assert not net.with_phase_decoder and not net.training
        assert all(torch.equal(t, got[name]) for name, t in net.state_dict().items())


def test_a_cut_vgg_keeps_the_init(files, monkeypatch):
    """conv4_1, which the cut file lacks, comes from ``init_net_params``
    (generator seed 0; a stand-in here that marks its leaves), every other
    leaf from the files."""
    from style_transfer_based_holographic_imaging_tpu_torch.models import net as net_module

    def marked_init(generator, width, with_phase_decoder):
        assert generator.initial_seed() == 0 and width == 1.0 and not with_phase_decoder
        with torch.device("meta"):
            shapes = StyleTransferNet().state_dict()
        return {k: torch.full(v.shape, 7.0) for k, v in shapes.items()}

    monkeypatch.setattr(net_module, "init_net_params", marked_init)
    args = (files["vgg_cut"], files["decoder"], files["distance"])
    got = load_reference_checkpoint(*args)
    want = jax_converted(*args)
    assert "encoder.conv4_1.weight" not in want
    for name, t in got.items():
        assert torch.equal(t, want[name]) if name in want else bool((t == 7.0).all()), name


def test_rgb_stem_is_collapsed(files):
    rgb = torch.load(files["vgg"])["0.weight"]
    got = load_reference_checkpoint(files["vgg"], files["decoder"], files["distance"])["encoder.stem.weight"]
    assert rgb.shape == (3, 3, 1, 1) and got.shape == (3, 1, 1, 1)
    assert torch.equal(got, torch.from_numpy(rgb.numpy().sum(axis=1, keepdims=True)))
    kept = ptw.convert_vgg_state_dict(ptw.load_torch_tensor(files["vgg"]), collapse_rgb_stem=False)
    assert torch.equal(kept["stem.weight"], rgb)


def test_shape_mismatch_raises_and_names_the_layer(files, tmp_path):
    state = torch.load(files["vgg"])
    state["2.weight"] = torch.zeros(64, 64, 3, 3)  # conv1_1 takes 3 input channels
    vgg = str(tmp_path / "vgg.pth")
    torch.save(state, vgg)
    with pytest.raises(ValueError, match="conv1_1"):
        load_reference_checkpoint(vgg, files["decoder"], files["distance"])


def test_style_vector_pt_round_trips_with_the_jax_package(tmp_path):
    rng = np.random.default_rng(4)
    mean = rng.random((1, 1, 1, 512)).astype(np.float32)
    std = (rng.random((1, 1, 1, 512)) + 0.5).astype(np.float32)
    mine, theirs = str(tmp_path / "port.pt"), str(tmp_path / "jax.pt")
    save_style_vector_pt(mean, std, mine)
    jtw.save_style_vector_pt(mean, std, theirs)
    assert torch.equal(torch.load(mine), torch.load(theirs))
    assert torch.load(mine).shape == (2, 512, 1, 1)
    for path in (mine, theirs):
        for got, want in zip(load_style_vector_pt(path), jtw.load_style_vector(path)):
            assert got.dtype == np.float32 and np.array_equal(got, want)
        got_m, got_s = load_style_vector_pt(path)
        assert np.array_equal(got_m, mean) and np.array_equal(got_s, std)
    torch.save(torch.zeros(3, 512, 1, 1), mine)
    with pytest.raises(ValueError, match="expected"):
        load_style_vector_pt(mine)


def test_extract_style_writes_the_pt_layout(tmp_path, monkeypatch):
    """On a seeded width-0.25 net as a training snapshot; the flag's
    plumbing is under test, so the config is cut to that width and two
    holograms a batch, and the default bank's sklearn digits (whose import
    alone takes seconds) are the golden suite's."""
    run = tmp_path / "run" / "iter_0"
    run.mkdir(parents=True)
    torch.save({"params": init_net_params(torch.Generator().manual_seed(0), width=0.25)}, str(run / "state.pt"))
    cfg = ExperimentConfig()
    small = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, batch_size=2),
                                model=dataclasses.replace(cfg.model, width=0.25))
    monkeypatch.setattr(cli, "ExperimentConfig", lambda: small)
    monkeypatch.setattr(synth, "sklearn_digit_bank", lambda: synth.golden_digit_bank(load_golden_suite()))
    out, pt = str(tmp_path / "sv.npz"), str(tmp_path / "sv.pt")
    argv = ["extract-style", "--cpu", "--checkpoint", str(run.parent), "--n-batches", "1",
            "--out", out, "--pt-out", pt]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        assert cli.main(argv) == 0
    assert buf.getvalue().splitlines()[-2:] == [
        f"torch-layout style vector written to {pt}", f"style vector written to {out}"]
    mean, std = load_style_vector(out)
    sv = torch.load(pt)
    assert sv.dtype == torch.float32 and sv.shape == (2, mean.size, 1, 1) == (2, 128, 1, 1)
    got_m, got_s = load_style_vector_pt(pt)
    assert np.array_equal(got_m, mean) and np.array_equal(got_s, std)
