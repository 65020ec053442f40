"""The port's HTTP retrieval server (``pipelines/server.py``) against the JAX
package's, on the CPU.

* ``RetrievalService`` on ``device="cpu"`` against the JAX package's
  ``RetrievalService`` on the same holograms (golden batch 10, five
  holograms: a batch of 4 and a padded one), weights (the ``fast``
  release; on seeded weights the focused field's amplitude is about 1e-5
  and its phase undefined at many pixels) and style vector, with the
  release's int8 scales: fp32 within 1e-4 of max|ref| (the nets sum
  in another order; phases modulo 2 pi); bf16 and int8 to the int8 path's
  rule of tests/test_torch_retrieval.py (amp_foc within 2e-2 of max|ref|,
  distance_pred within 1e-2, the zero-meaned ph_foc within 3e-2 rad in
  99.9 % of the pixels); ``refine_steps`` 5 (fp32, amplitude and phase
  refined jointly) to the refine rule of tests/test_torch_refine.py (the
  mean and the 99th percentile of |diff| within 1e-3: Adam's per-pixel
  scaling turns FFT rounding into step-sized moves at a few pixels).
* B = 1 and B = batch + 3 (padded and chunked) against direct retrieval
  calls on the padded chunks, bit for bit.
* An HTTP round trip through ``serve_forever`` on port 0 and
  ``retrieve_remote``; a 400 for a request without ``holo``, a 404 for an
  unknown path, ``/healthz`` with the JAX package's keys.
"""

import io
import json
import math
import os
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_cpu_threads import warm_torch_threads  # noqa: F401

from style_transfer_based_holographic_imaging_tpu.config import ExperimentConfig as JConfig
from style_transfer_based_holographic_imaging_tpu.pipelines import server as jserver
from style_transfer_based_holographic_imaging_tpu_torch import ExperimentConfig
from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite
from style_transfer_based_holographic_imaging_tpu_torch.interop import (
    load_release_weights,
    load_style_vector,
)
from style_transfer_based_holographic_imaging_tpu_torch.models import StyleTransferNet, quant
from style_transfer_based_holographic_imaging_tpu_torch.pipelines import (
    RetrievalService,
    make_retrieval_fn,
    retrieve_remote,
    serve_forever,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAST = os.path.join(REPO, "checkpoints", "fast")
WIDTH, N, BATCH = 0.5, 128, 4
TOL = 1e-4
INT8_RULE = dict(amp=2e-2, dist=1e-2, phase=3e-2, fraction=0.999)
REFINE_TOL = 1e-3


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


def _wrapped(d):
    return np.abs(np.mod(d + math.pi, 2 * math.pi) - math.pi)


def _zm(x):
    return x - x.mean(axis=(-2, -1), keepdims=True)


@pytest.fixture(scope="module")
def setup():
    ocp = pytest.importorskip("orbax.checkpoint")
    params = ocp.StandardCheckpointer().restore(os.path.join(FAST, "release"))["params"]
    state = load_release_weights(os.path.join(FAST, "torch_weights.npz"))
    holo = load_golden_suite().content_holo[10]
    style = load_style_vector(os.path.join(FAST, "style_vector.npz"))
    scales = quant.load_scales(os.path.join(FAST, "quant_scales.json"))
    with open(os.path.join(FAST, "config.json")) as f:
        text = f.read()
    cfg, jcfg = ExperimentConfig.from_json(text), JConfig.from_json(text)
    assert cfg.model.width == WIDTH and cfg.model.image_size == N
    return params, state, holo, style, scales, cfg, jcfg


def _services(setup, **kw):
    params, state, holo, style, scales, cfg, jcfg = setup
    port = RetrievalService(StyleTransferNet.from_state_dict(state, WIDTH), style, cfg,
                            batch_size=BATCH, device="cpu", **kw)
    jkw = dict(kw)
    if jkw.get("dtype") is not None:
        jkw["dtype"] = jnp.bfloat16
    ref = jserver.RetrievalService(params, style, jcfg, batch_size=BATCH, **jkw)
    return port, ref


@pytest.mark.parametrize("mode", ["fp32", "bf16", "int8", "refine5"])
def test_service_matches_jax(setup, mode):
    scales = setup[4]
    kw = {"fp32": {}, "bf16": {"dtype": torch.bfloat16}, "int8": {"quant_scales": scales},
          "refine5": {"refine_steps": 5}}[mode]
    port, ref_service = _services(setup, **kw)
    holo = setup[2]
    got, ref = port.retrieve(holo), ref_service.retrieve(holo)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == np.float32 and got[k].shape == ref[k].shape, k
    dph = _wrapped(_zm(got["ph_foc"]) - _zm(ref["ph_foc"]))
    if mode == "fp32":
        for k in ("amp_foc", "amp_field", "ph_field", "distance_pred"):
            assert _rel(got[k], ref[k]) < TOL, k
        assert dph.max() < TOL * np.abs(ref["ph_foc"]).max()
    elif mode == "refine5":
        assert _rel(got["distance_pred"], ref["distance_pred"]) < TOL
        for d in (np.abs(got["amp_foc"] - ref["amp_foc"]), dph):
            print(f"refine: mean {d.mean():.3g}, 99th percentile {np.percentile(d, 99):.3g}")
            assert d.mean() < REFINE_TOL and np.percentile(d, 99) < REFINE_TOL
    else:
        assert _rel(got["amp_foc"], ref["amp_foc"]) < INT8_RULE["amp"]
        assert np.abs(got["distance_pred"] - ref["distance_pred"]).max() < INT8_RULE["dist"]
        assert (dph < INT8_RULE["phase"]).mean() >= INT8_RULE["fraction"]
    assert port.n_served == len(holo)


@pytest.fixture(scope="module")
def service(setup):
    return RetrievalService(StyleTransferNet.from_state_dict(setup[1], WIDTH), setup[3], setup[5],
                            batch_size=BATCH, device="cpu")


@pytest.mark.parametrize("b", [1, BATCH + 3])
def test_requests_are_padded_and_chunked(setup, service, b):
    rng = np.random.default_rng(b)
    holo = (rng.random((b, 1, N, N)) * 0.6 + 0.05).astype(np.float32)
    got = service.retrieve(holo)
    fn = make_retrieval_fn(setup[5].physics, device="cpu")
    d_style = float(setup[5].physics.to_network_units(setup[5].data.style_distances[0]))
    for lo in range(0, b, BATCH):
        chunk = holo[lo : lo + BATCH]
        n = len(chunk)
        chunk = np.concatenate([chunk, np.repeat(chunk[-1:], BATCH - n, axis=0)])
        want = fn(service.net, chunk, *service_style(setup), d_style)
        for k, v in got.items():
            assert v.shape[0] == b
            assert np.array_equal(v[lo : lo + n], want[k][:n].numpy()), k


def service_style(setup):
    sm, ss = setup[3]
    return torch.from_numpy(sm), torch.from_numpy(ss)


def test_bad_shapes_are_refused(service):
    for bad in (np.zeros((0, 1, N, N), np.float32), np.zeros((2, 2, N, N), np.float32),
                np.zeros((2, 1, N, N + 1), np.float32)):
        with pytest.raises(ValueError):
            service.retrieve(bad)


@pytest.fixture(scope="module")
def server_url(service):
    bound = threading.Event()
    box = {}

    def ready(httpd):
        box["httpd"] = httpd
        bound.set()

    t = threading.Thread(target=serve_forever, args=(service, "127.0.0.1", 0),
                         kwargs={"ready": ready}, daemon=True)
    t.start()
    assert bound.wait(30)
    yield f"http://127.0.0.1:{box['httpd'].server_address[1]}"
    box["httpd"].shutdown()
    t.join(30)
    assert not t.is_alive()


def test_http_round_trip(server_url, service):
    holo = (np.random.default_rng(7).random((3, 1, N, N)) * 0.6 + 0.05).astype(np.float32)
    got = retrieve_remote(server_url, holo)
    want = service.retrieve(holo)
    assert set(got) == set(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_http_errors_and_health(server_url, setup):
    buf = io.BytesIO()
    np.savez(buf, nope=np.zeros(3))
    req = urllib.request.Request(server_url + "/retrieve", data=buf.getvalue(), method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 400 and "holo" in json.loads(e.value.read())["error"]
    for req in (urllib.request.Request(server_url + "/nope"),
                urllib.request.Request(server_url + "/nope", data=b"x", method="POST")):
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 404
    with urllib.request.urlopen(server_url + "/healthz", timeout=60) as r:
        health = json.loads(r.read())
    _, ref_service = _services(setup)
    assert set(health) == set(ref_service.health())
    assert health["device"] == "cpu" and health["batch_size"] == BATCH
    assert health["width"] == WIDTH and health["quantized"] is False
    # still serving after the errors
    assert retrieve_remote(server_url, np.full((1, 1, N, N), 0.2, np.float32))["amp_foc"].shape == (1, 1, N, N)
