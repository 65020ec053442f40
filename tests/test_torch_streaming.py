"""The port's stream (``pipelines/streaming.py``) and its prefetch
(``data/prefetch.py``) against the JAX package's, on the CPU.

``stream_retrieval`` on the ``fast`` release (fp32) over golden holograms,
against the JAX package's ``stream_retrieval`` on the same batches: a ragged
stream (4, 4, 2: the tail padded to the first batch's size and trimmed) and
a batch larger than the first (2, then 5: chunked to 2, 2 and a padded 1),
within 1e-4 of max|ref| (the nets sum in another order; phases modulo
2 pi); with ``refine_steps`` 3 (amplitude and phase refined jointly), the
refine rule of tests/test_torch_refine.py (mean and 99th percentile of
|diff| within 1e-3). ``StreamStats`` counts the frames yielded; the CPU
prefetch keeps order and re-raises the producer's error.
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_cpu_threads import warm_torch_threads  # noqa: F401

from style_transfer_based_holographic_imaging_tpu.config import ExperimentConfig as JConfig
from style_transfer_based_holographic_imaging_tpu.pipelines import streaming as jstreaming
from style_transfer_based_holographic_imaging_tpu_torch import ExperimentConfig
from style_transfer_based_holographic_imaging_tpu_torch.data import (
    load_golden_suite,
    prefetch_to_device,
)
from style_transfer_based_holographic_imaging_tpu_torch.interop import (
    load_release_weights,
    load_style_vector,
)
from style_transfer_based_holographic_imaging_tpu_torch.models import StyleTransferNet
from style_transfer_based_holographic_imaging_tpu_torch.pipelines import (
    StreamStats,
    stream_retrieval,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST = os.path.join(REPO, "checkpoints", "fast")
TOL, REFINE_TOL = 1e-4, 1e-3
STREAMS = {"ragged": (4, 4, 2), "larger_than_first": (2, 5)}


@pytest.fixture(scope="module")
def fast():
    ocp = pytest.importorskip("orbax.checkpoint")
    params = ocp.StandardCheckpointer().restore(os.path.join(FAST, "release"))["params"]
    with open(os.path.join(FAST, "config.json")) as f:
        text = f.read()
    cfg = ExperimentConfig.from_json(text)
    net = StyleTransferNet.from_state_dict(
        load_release_weights(os.path.join(FAST, "torch_weights.npz")), cfg.model.width)
    style = load_style_vector(os.path.join(FAST, "style_vector.npz"))
    holo = load_golden_suite().content_holo[:2].reshape(-1, 1, 128, 128)
    return params, net, style, cfg, JConfig.from_json(text), holo


def _batches(holo, sizes):
    bounds = np.cumsum((0,) + sizes)
    return [{"holo": holo[lo:hi]} for lo, hi in zip(bounds[:-1], bounds[1:])]


def _wrapped(d):
    return np.abs(np.mod(d + math.pi, 2 * math.pi) - math.pi)


@pytest.mark.parametrize("stream,refine_steps", [("ragged", 0), ("larger_than_first", 0),
                                                 ("ragged", 3)])
def test_stream_matches_jax(fast, stream, refine_steps):
    params, net, style, cfg, jcfg, holo = fast
    sizes = STREAMS[stream]
    stats = StreamStats()
    got = list(stream_retrieval(net, _batches(holo, sizes), style, cfg, stats=stats,
                                refine_steps=refine_steps, device="cpu"))
    ref = list(jstreaming.stream_retrieval(
        params, _batches(holo, sizes), (jnp.asarray(style[0]), jnp.asarray(style[1])), jcfg,
        refine_steps=refine_steps))
    assert [o["amp_foc"].shape[0] for o in got] == [o["amp_foc"].shape[0] for o in ref]
    assert stats.n_frames == sum(sizes) and stats.frames_per_sec > 0
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in r:
            gk, rk = g[k].numpy(), np.asarray(r[k])
            assert g[k].dtype == torch.float32 and gk.shape == rk.shape, k
            if k == "ph_foc":
                d = _wrapped(gk - rk)
            else:
                d = np.abs(gk - rk)
            if refine_steps and k in ("amp_foc", "ph_foc"):
                assert d.mean() < REFINE_TOL and np.percentile(d, 99) < REFINE_TOL, k
            else:
                assert d.max() < TOL * np.abs(rk).max(), k


def test_stats_count_the_frames_yielded(fast):
    _, net, style, cfg, _, holo = fast
    stats = StreamStats()
    assert stats.n_frames == 0
    it = stream_retrieval(net, _batches(holo, (3, 3, 1)), style, cfg, stats=stats, device="cpu")
    counts = []
    for out in it:
        counts.append(stats.n_frames)
    assert counts == [3, 6, 7]
    assert stats.elapsed > 0 and stats.frames_per_sec == pytest.approx(7 / stats.elapsed, rel=0.5)


def test_cpu_prefetch_keeps_order_and_reraises():
    src = [{"holo": np.full((2, 1, 4, 4), i, np.float32), "i": np.array([i])} for i in range(5)]
    got = list(prefetch_to_device(iter(src), device="cpu"))
    assert [int(b["i"][0]) for b in got] == list(range(5))
    assert all(torch.is_tensor(b["holo"]) and torch.equal(b["holo"], torch.from_numpy(s["holo"]))
               for b, s in zip(got, src))

    def failing():
        yield {"holo": np.zeros((1, 1, 4, 4), np.float32)}
        raise OSError("disk gone")

    it = prefetch_to_device(failing(), device="cpu")
    assert next(it)["holo"].shape == (1, 1, 4, 4)
    with pytest.raises(OSError, match="disk gone"):
        next(it)
