"""The port's orbax restore (``interop/zstd.py``, ``interop/ocdbt.py``,
``interop/orbax_read.py``, ``train.load_release_params`` and the orbax
snapshots of ``train/state.py``) against the libraries the JAX package
uses, on the CPU.

* The zstd decoder (``interop/csrc/zstd_decode.cc``) against the
  ``zstandard`` package's compressor, which only this test imports: float32
  payloads (random and smooth) and bytes that give RLE blocks, raw blocks,
  raw literals, and Huffman tables with direct and FSE-coded weights; levels
  1, 3 and 19; frames of several blocks, with and without a content
  checksum and a content size; skippable and concatenated frames. Equal
  byte for byte. Truncated and corrupted frames, and a frame that needs a
  dictionary, raise.
* The OCDBT reader against TensorStore on a store it wrote with small
  nodes (a B-tree of several levels, inline and out-of-line values, several
  versions); the footer is CRC-32C: a flipped byte in a node makes both
  readers refuse the copy.
* ``restore`` against ``ocp.StandardCheckpointer().restore`` on every leaf
  of all eight committed releases, bit for bit in values, dtypes and shapes
  (``bead_release``, saved on a TPU, restored by orbax into
  ``rbc_release``'s tree, as the JAX package must); zarr arrays of several
  chunks, missing chunks, ``F`` order, no compressor and a big-endian
  dtype against TensorStore's zarr driver.
* ``checkpoints/fast/torch_weights.npz`` equals its orbax release bit for
  bit; ``cli._load_params`` with no ``--checkpoint`` (the repository's root
  as the working directory) equals ``convert_params`` of orbax's restore of
  ``checkpoints/release``.
* A JAX ``iter_<n>`` snapshot (the JAX package's ``save_checkpoint``, width
  0.25, EMA and discriminator) restores in the port equal to
  ``convert_train_state`` of the JAX state in memory, and a port step from
  each is the same step; ``cli train --resume`` continues a JAX run (width
  1.0, the flagship's weights) from its snapshot.
"""

import argparse
import dataclasses
import io
import json
import os
import shutil

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
import zstandard
from torch_cpu_threads import warm_few_torch_threads  # noqa: F401

from style_transfer_based_holographic_imaging_tpu.config import ExperimentConfig as JConfig
from style_transfer_based_holographic_imaging_tpu.train.state import create_train_state as j_create
from style_transfer_based_holographic_imaging_tpu.train.state import save_checkpoint as j_save
from style_transfer_based_holographic_imaging_tpu_torch import ExperimentConfig, cli
from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite, synth
from style_transfer_based_holographic_imaging_tpu_torch.interop import (
    convert_params,
    convert_train_state,
    load_release_weights,
    ocdbt,
    orbax_read,
    zstd,
)
from style_transfer_based_holographic_imaging_tpu_torch.models import (
    PatchDiscriminator,
    StyleTransferNet,
    init_net_params,
    init_params,
)
from style_transfer_based_holographic_imaging_tpu_torch.train import (
    TrainStep,
    latest_snapshot,
    load_release_params,
    load_train_params,
    restore_checkpoint,
)
from style_transfer_based_holographic_imaging_tpu_torch.train.state import create_train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints")
RELEASES = ("release", "adv_release", "rbc_release", "bead_release", "fast/release", "balanced/release",
            "turbo/release", "ultra/release")
with open(os.path.join(CKPT, "config.json")) as _f:
    CONFIG_TEXT = _f.read()


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (str(i),))
    else:
        yield prefix, tree


def assert_trees_equal(got, want):
    """The same leaves by path, each None in both or equal bit for bit with
    the same dtype and shape."""
    got, want = dict(_flat(got)), dict(_flat(want))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        if w is None:
            assert g is None, path
            continue
        w = np.asarray(w)
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype and g.shape == w.shape, path
        assert np.array_equal(g, w), path


def assert_state_dicts_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


# --------------------------------------------------------------------------
# The zstd decoder
# --------------------------------------------------------------------------


def _payloads():
    rng = np.random.default_rng(0)
    n = 1 << 16
    nibbles = rng.choice(16, 4 * n, p=np.r_[[0.3, 0.2, 0.1, 0.1], np.full(12, 0.3 / 12)])
    noise = rng.integers(0, 256, 3 * n, dtype=np.uint8).tobytes()
    return {
        "random_f32": rng.standard_normal(n).astype(np.float32).tobytes(),
        "smooth_f32": np.sin(np.arange(n) / 50.0).astype(np.float32).tobytes(),
        "zeros": bytes(3 * n),                       # RLE blocks
        "random_bytes": noise,                       # raw blocks
        "raw_literals": b"".join(noise[i:i + 6000] + noise[:2000] for i in range(0, 3 * n, 6000)),
        "text": b"".join(b"line %d of the text, abracadabra\n" % (i % 977) for i in range(8000)),
        "nibbles": nibbles.astype(np.uint8).tobytes(),  # direct Huffman weights
    }


PAYLOADS = _payloads()


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("payload", sorted(PAYLOADS))
def test_zstd_decodes_what_zstandard_compresses(payload, level, checksum):
    data = PAYLOADS[payload]
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(data)
    assert zstd.decompress(frame, len(data)) == data
    assert zstd.decompress(frame) == data
    out = np.empty(len(data), np.uint8)
    zstd.decompress_into(frame, out)
    assert out.tobytes() == data


@pytest.mark.parametrize("level", [1, 19])
def test_zstd_streamed_frames_without_content_size(level):
    """Blocks flushed one by one, no content size: the output grows."""
    data = PAYLOADS["smooth_f32"] + PAYLOADS["text"]
    buf = io.BytesIO()
    writer = zstandard.ZstdCompressor(level=level, write_checksum=True).stream_writer(buf, closefd=False)
    for i in range(0, len(data), 50_000):
        writer.write(data[i:i + 50_000])
        writer.flush(zstandard.FLUSH_BLOCK)
    writer.close()
    assert zstd.decompress(buf.getvalue()) == data


def test_zstd_concatenated_and_skippable_frames():
    a = zstandard.ZstdCompressor(level=3).compress(b"abc" * 1000)
    skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
    assert zstd.decompress(a + skippable + a) == b"abc" * 2000


def _bad_frames():
    data = PAYLOADS["random_f32"]
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
    flip = lambda i: frame[:i] + bytes([frame[i] ^ 0x10]) + frame[i + 1:]  # noqa: E731
    return {
        "truncated_header": frame[:5],
        "truncated_block": frame[:len(frame) // 2],
        "truncated_checksum": frame[:-2],
        "bad_magic": b"\x00" + frame[1:],
        "flipped_early": flip(40),
        "flipped_middle": flip(len(frame) // 2),
        "flipped_checksum": flip(len(frame) - 1),
    }


@pytest.mark.parametrize("case", sorted(_bad_frames()))
def test_zstd_truncated_or_corrupted_frames_raise(case):
    frame = _bad_frames()[case]
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(frame, len(PAYLOADS["random_f32"]))


def test_zstd_a_frame_that_needs_a_dictionary_raises():
    samples = [b"sample %d of a dictionary, with words: holography style transfer %d" % (i, i * i)
               for i in range(400)]
    dictionary = zstandard.train_dictionary(1024, samples)
    frame = zstandard.ZstdCompressor(dict_data=dictionary).compress(samples[7])
    with pytest.raises(zstd.ZstdError, match="dictionary"):
        zstd.decompress(frame)


def test_crc32c_is_castagnoli():
    assert zstd.crc32c(b"123456789") == 0xE3069283
    assert zstd.crc32c(b"") == 0


# --------------------------------------------------------------------------
# OCDBT
# --------------------------------------------------------------------------


def _ts_ocdbt(path, **config):
    spec = {"driver": "ocdbt", "base": f"file://{path}/"}
    if config:
        spec["config"] = config
    return ts.KvStore.open(spec).result()


def test_ocdbt_reads_a_tensorstore_btree(tmp_path):
    """Nodes of 400 bytes at most: an interior level or more; values of
    more than 16 bytes out of line; two commits, so two versions."""
    kv = _ts_ocdbt(str(tmp_path), max_decoded_node_bytes=400, max_inline_value_bytes=16)
    for lo, hi in ((0, 200), (150, 300)):
        with ts.Transaction() as txn:
            for i in range(lo, hi):
                kv.with_transaction(txn)[f"group{i // 50}/key{i:04d}/.zarray"] = (b"v%d." % i) * (1 + i % 11)
    store = ocdbt.Store(str(tmp_path))
    assert store.height > 0 and store.generation > 1
    want = {k.decode(): kv.read(k).result().value for k in kv.list().result()}
    assert store.list_keys() == sorted(want) == ocdbt.list_keys(str(tmp_path))
    assert all(store.read(k) == v for k, v in want.items())
    assert ocdbt.read(str(tmp_path), "group5/key0299/.zarray") == want["group5/key0299/.zarray"]


@pytest.mark.parametrize("target", ["node", "manifest"])
def test_ocdbt_a_flipped_byte_fails_the_checksum(tmp_path, target):
    """A copy of ``fast``'s release with one byte of its top-level B-tree
    node (or its manifest) flipped: the port's reader raises, and so does
    TensorStore's, which checks the same CRC-32C."""
    copy = tmp_path / "release"
    shutil.copytree(os.path.join(CKPT, "fast", "release"), copy)
    path = copy / "manifest.ocdbt" if target == "manifest" else next((copy / "d").iterdir())
    blob = bytearray(path.read_bytes())
    blob[20] ^= 0x01
    path.write_bytes(bytes(blob))
    with pytest.raises(ocdbt.OcdbtError, match="checksum mismatch"):
        ocdbt.Store(str(copy)).list_keys()
    with pytest.raises(Exception):
        _ts_ocdbt(str(copy)).list().result()


# --------------------------------------------------------------------------
# orbax restore
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def releases():
    """Each release restored once by the port and once by orbax."""
    out = {}
    ckptr = ocp.StandardCheckpointer()
    for rel in RELEASES:
        path = os.path.join(CKPT, rel)
        got = orbax_read.restore(path)
        if rel == "bead_release":
            # saved on a TPU: orbax restores it only into a host tree
            want = ckptr.restore(path, jax.tree.map(np.zeros_like, out["rbc_release"][0]))
        else:
            want = ckptr.restore(path)
        out[rel] = (got, want)
    return out


@pytest.mark.parametrize("release", RELEASES)
def test_restore_equals_orbax_bit_for_bit(releases, release):
    got, want = releases[release]
    assert len(list(_flat(got))) == 56
    assert_trees_equal(got, want)


def test_fast_npz_equals_its_orbax_release(releases):
    got = load_release_weights(os.path.join(CKPT, "fast", "torch_weights.npz"))
    assert_state_dicts_equal(got, convert_params(releases["fast/release"][0]["params"]))
    assert_state_dicts_equal(load_release_params(os.path.join(CKPT, "fast", "release")), got)


def test_load_params_defaults_to_the_flagship_release(releases, monkeypatch):
    monkeypatch.chdir(REPO)
    got = cli._load_params(argparse.Namespace(checkpoint=None))
    assert_state_dicts_equal(got, convert_params(jax.device_get(releases["release"][1]["params"])))


def test_restore_reads_chunked_zarr_arrays(tmp_path):
    """Arrays TensorStore's zarr driver wrote into one OCDBT store, under
    an orbax ``_METADATA``: several chunks (the last ones ragged, one never
    written), ``F`` order without a compressor, a big-endian dtype, a 0-d
    integer."""
    rng = np.random.default_rng(3)
    arrays = {
        "a.chunked": (rng.standard_normal((7, 10)).astype("<f4"), dict(chunks=[3, 4], order="C")),
        "a.fortran": (rng.standard_normal((5, 6)).astype("<f8"), dict(chunks=[2, 6], order="F", compressor=None)),
        "b.big_endian": (rng.standard_normal((4, 3)).astype(">f4"), dict(chunks=[4, 3], order="C")),
        "c": (np.array(42, "<i4"), dict(chunks=[], order="C")),
    }
    want = {}
    for name, (value, meta) in arrays.items():
        meta = {"compressor": {"id": "zstd", "level": 1}, **meta}
        arr = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}/",
                                                     "path": f"{name}/"},
                       "metadata": {"shape": list(value.shape), "dtype": value.dtype.str, **meta},
                       "create": True}).result()
        if name == "a.chunked":
            arr[:6, :].write(value[:6]).result()     # the last row of chunks stays unwritten
            value = value.copy()
            value[6:] = 0
        else:
            arr.write(value).result()
        want[name] = value
    tree_metadata = {}
    for name in arrays:
        keys = name.split(".")
        tree_metadata[str(tuple(keys))] = {
            "key_metadata": [{"key": k, "key_type": 2} for k in keys],
            "value_metadata": {"value_type": "np.ndarray", "skip_deserialize": False}}
    (tmp_path / "_METADATA").write_text(json.dumps({"tree_metadata": tree_metadata, "use_ocdbt": True,
                                                    "use_zarr3": False}))
    got = orbax_read.restore(str(tmp_path))
    for name, value in want.items():
        node = got
        for k in name.split("."):
            node = node[k]
        assert node.dtype == value.dtype.newbyteorder("=") and node.shape == value.shape, name
        assert np.array_equal(node, value), name


# --------------------------------------------------------------------------
# JAX snapshots: restore, resume, cli train --resume
# --------------------------------------------------------------------------


def _configs(**train_kw):
    out = []
    for cls in (JConfig, ExperimentConfig):
        c = cls.from_json(CONFIG_TEXT)
        out.append(dataclasses.replace(
            c, model=dataclasses.replace(c.model, width=0.25),
            data=dataclasses.replace(c.data, batch_size=2, image_size=64, digit_pad=16),
            train=dataclasses.replace(c.train, **train_kw)))
    return out


def _jax_tree(state):
    """A port state dict in the JAX layout (the inverse of
    ``convert_params``), under ``'params'``."""
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


def _jax_state(jcfg, params, disc_params, steps: int, seed: int):
    """A JAX ``TrainState`` as after ``steps`` steps: the JAX package's
    ``create_train_state`` with every float leaf of the params, the EMA and
    the optimizer states drawn from a seeded normal (the second moments
    positive) and every count set to ``steps``."""
    rng = np.random.default_rng(seed)

    def draw(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.integer):
            return np.full_like(x, steps)
        return (x + 0.01 * rng.standard_normal(x.shape, np.float32)).astype(x.dtype)

    jstate = j_create(params, jcfg.train, disc_params=disc_params)
    fields = {k: jax.tree.map(draw, jax.device_get(getattr(jstate, k)))
              for k in ("params", "opt_state", "disc_params", "disc_opt_state", "ema_params")
              if getattr(jstate, k) is not None}
    for k in ("opt_state", "disc_opt_state"):
        if k in fields:
            fields[k] = jax.tree.map(np.abs, fields[k])
    return jstate.replace(step=np.int32(steps), **fields)


def _in_memory(jstate) -> dict:
    return {k: jax.device_get(getattr(jstate, k)) for k in
            ("step", "params", "opt_state", "disc_params", "disc_opt_state", "ema_params")
            if getattr(jstate, k) is not None}


def _assert_port_states_equal(got, want):
    assert got.step == want.step and got.opt_state.count == want.opt_state.count
    assert got.disc_opt_state.count == want.disc_opt_state.count
    for field in ("params", "ema_params", "disc_params"):
        assert_state_dicts_equal(getattr(got, field), getattr(want, field))
    for a, b in ((got.opt_state, want.opt_state), (got.disc_opt_state, want.disc_opt_state)):
        assert_state_dicts_equal(a.mu, b.mu)
        assert_state_dicts_equal(a.nu, b.nu)


def test_a_jax_snapshot_resumes_in_the_port(tmp_path):
    """The discriminator narrowed to 8 channels at its first conv: the
    default's 45 M parameters would make the snapshot 0.5 GB."""
    jcfg, cfg = _configs(ema_decay=0.9)
    params = init_net_params(torch.Generator().manual_seed(0), width=0.25)
    disc = PatchDiscriminator(image_size=64, conv_dim=8)
    disc_params = init_params(disc, torch.Generator().manual_seed(1))
    jstate = _jax_state(jcfg, _jax_tree(params), _jax_tree(disc_params), steps=2, seed=5)
    snap = j_save(jstate, str(tmp_path), step=2)
    assert latest_snapshot(str(tmp_path)) == snap

    fresh = create_train_state(params, cfg.train, disc_params=disc_params, device="cpu")
    resumed = restore_checkpoint(snap, fresh)
    converted = convert_train_state(_in_memory(jstate), device="cpu")
    _assert_port_states_equal(resumed, converted)
    assert resumed.step == 2
    assert_state_dicts_equal(load_train_params(snap), converted.ema_params)
    assert_state_dicts_equal(load_train_params(snap, ema=False), converted.params)
    assert_state_dicts_equal(load_release_params(snap), converted.params)

    net = StyleTransferNet(width=0.25)
    net.load_state_dict(params)
    disc.load_state_dict(disc_params)
    bank = torch.from_numpy(synth.golden_digit_bank(load_golden_suite(), size=32, subset=synth.GOLDEN_TRAIN_DIGITS))
    batch = synth.synth_batch(2, bank, cfg.data, cfg.physics, return_gt=True)
    step = TrainStep(net, cfg.physics, cfg.train, disc=disc)
    a, _ = step(resumed, batch)
    b, _ = step(converted, batch)
    _assert_port_states_equal(a, b)
    assert a.step == 3


def test_cli_train_resumes_a_jax_run(releases, tmp_path, capsys):
    """``cli train --resume`` on a directory holding a JAX snapshot of the
    flagship (width 1.0, with EMA; no adversarial term, whose discriminator
    alone has 45 M parameters): one more step, from it."""
    jcfg = JConfig.from_json(CONFIG_TEXT)
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(jcfg.train, ema_decay=0.999, adv_weight=0.0))
    jstate = _jax_state(jcfg, releases["release"][0]["params"], None, steps=1, seed=6)
    j_save(jstate, str(tmp_path), step=1)
    rc = cli.main(["train", "--cpu", "--resume", "--checkpoint-dir", str(tmp_path), "--iterations", "2",
                   "--batch-size", "1", "--bank", "golden", "--log-every", "1", "--checkpoint-every", "1",
                   "--ema-decay", "0.999", "--adv-weight", "0", "--train-encoder"])
    assert rc == 0
    assert "resumed from iter_1 (step 1)" in capsys.readouterr().err
    assert latest_snapshot(str(tmp_path)).endswith("iter_2")
    before = convert_train_state(_in_memory(jstate), device="cpu")
    after = restore_checkpoint(latest_snapshot(str(tmp_path)), before)
    assert after.step == 2 and after.opt_state.count == 2
    moved = [k for k in before.params if not torch.equal(after.params[k], before.params[k])]
    assert set(moved) == set(before.params)
