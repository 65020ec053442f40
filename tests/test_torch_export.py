"""The kernels as ``holostyle::`` ops and the frozen serving artifact
(``pipelines/export_artifact.py``), on the CPU, against the port's live path
and the JAX package's.

* Each of the seven ops passes ``torch.library.opcheck`` (schema, autograd
  registration, fake tensors, AOT dispatch) at small shapes; the ASM ops'
  gradients, called as ops, equal ``propagate_torch`` autograd to 1e-5 of
  the largest gradient (``highest``, where the plain forward is fp32).
* A seeded width-0.25 net (numpy through the weight bridge, 128^2, batch 2):
  the fp32, bf16 and int8 artifacts equal the port's live
  ``make_retrieval_fn`` bit for bit (the same aten graph, undecomposed); the
  fp32 artifact equals the JAX package's live program to
  ``tests/test_torch_retrieval.py``'s tolerances (amp_foc 1e-4 of max,
  distance 1e-4, the phase within 1e-4 rad but on 1e-4 of its pixels, which
  miss by whole cycles).
* Requests of 1, 3 and 5 against batch 2 are padded and chunked as the
  server pads them; ``_RESULT_KEYS`` is the server's object.
* A bad magic, a JAX header and ``cuda`` on this card-less host are refused.
* A fresh process loads and runs an artifact with no ``jax`` and no port
  module under ``models`` or ``pipelines.field_retrieval`` imported.
* ``evaluate_golden_suite(None, suite, retrieval_fn=...)`` over an
  artifact of the suite's batch (5) equals ``evaluate_golden_suite(net,
  suite)``.
* ``ArtifactService`` behind ``serve_forever``: a request equals
  ``retrieve``; ``/healthz`` has the JAX service's keys.
"""

import json
import math
import os
import subprocess
import sys
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_cpu_threads import warm_few_torch_threads  # noqa: F401
from torch_seeded import seeded_net, seeded_params, seeded_style

from style_transfer_based_holographic_imaging_tpu.config import ExperimentConfig as JConfig
from style_transfer_based_holographic_imaging_tpu.pipelines import field_retrieval as jfr
from style_transfer_based_holographic_imaging_tpu_torch import ExperimentConfig
from style_transfer_based_holographic_imaging_tpu_torch.data import load_golden_suite
from style_transfer_based_holographic_imaging_tpu_torch.kernels import library
from style_transfer_based_holographic_imaging_tpu_torch.models import quant
from style_transfer_based_holographic_imaging_tpu_torch.ops.asm import propagate_torch
from style_transfer_based_holographic_imaging_tpu_torch.pipelines import (
    ArtifactService,
    evaluate_golden_suite,
    export_artifact,
    make_retrieval_fn,
    retrieve_remote,
    serve_forever,
    server,
)
from style_transfer_based_holographic_imaging_tpu_torch.pipelines.export_artifact import (
    export_retrieval,
    load_artifact,
    read_artifact,
    save_artifact,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH, N, BATCH = 0.25, 128, 2
# The golden suite's batch: the CPU's conv sums a batch's images in an order
# that may depend on the batch size, so the suite's artifact takes its batch.
SUITE_BATCH = 5
CFG = ExperimentConfig()
D_STYLE = float(CFG.physics.to_network_units(CFG.data.style_distances[0]))
KW = dict(wavelength=CFG.physics.wavelength, pixel_size=CFG.physics.pixel_size)


# --------------------------------------------------------------------------
# The ops
# --------------------------------------------------------------------------


def _op_cases():
    g = torch.Generator().manual_seed(7)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    planes = (r(2, 16, 16).requires_grad_(), r(2, 16, 16).requires_grad_())
    tail = (r(2, 8, 24, 12), r(8, 8, 3, 3), r(8), r(8, 8, 3, 3), r(8), r(2, 8, 3, 3), r(2))
    return {
        "asm_const": (*planes, -2e-4, KW["wavelength"], KW["pixel_size"], "high"),
        "asm_dynamic": (*planes, torch.tensor([1e-4, -2e-4], requires_grad=True),
                        KW["wavelength"], KW["pixel_size"], "high"),
        "border_lines": (r(2, 4, 9, 12).requires_grad_(), r(6, 4, 3, 3).requires_grad_()),
        "fused_encoder_head": (r(2, 1, 8, 12), r(8, 1, 3, 3), r(8), r(8, 8, 3, 3), r(8)),
        "fused_conv_tail": tail,
        "halo_interior": (*tail, 8),
        "halo_interior_static": (*tail, 8),
    }


def test_every_kernel_is_a_holostyle_op():
    assert library.registered() == ("asm_const", "asm_dynamic", "fused_encoder_head",
                                    "fused_conv_tail", "halo_interior", "halo_interior_static",
                                    "border_lines")


@pytest.mark.parametrize("name", sorted(_op_cases()))
def test_op_passes_opcheck(name):
    torch.library.opcheck(getattr(torch.ops.holostyle, name).default, _op_cases()[name])


@pytest.mark.parametrize("kind", ["const", "dynamic"])
def test_asm_op_gradients_match_torch_fft(kind):
    g = torch.Generator().manual_seed(3)
    xre, xim = torch.rand(3, 32, 24, generator=g), torch.rand(3, 32, 24, generator=g)
    w = torch.randn(2, 3, 32, 24, generator=g)
    dist = torch.tensor([4e-4, -2e-4, 6e-4])

    def grads(fn):
        x = [xre.clone().requires_grad_(), xim.clone().requires_grad_()]
        d = [dist.clone().requires_grad_()] if kind == "dynamic" else []
        yre, yim = fn(*x, *d)
        loss = (w[0] * yre + w[1] * yim * yim).sum()
        return torch.autograd.grad(loss, x + d)

    def op(xr, xi, d=None):
        if kind == "const":
            return torch.ops.holostyle.asm_const(xr, xi, -2e-4, *KW.values(), "highest")
        return torch.ops.holostyle.asm_dynamic(xr, xi, d, *KW.values(), "highest")

    def fft(xr, xi, d=-2e-4):
        y = propagate_torch(torch.complex(xr, xi), d.reshape(-1, 1, 1) if kind == "dynamic" else d, **KW)
        return y.real, y.imag

    for got, want in zip(grads(op), grads(fft)):
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


# --------------------------------------------------------------------------
# The artifacts
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    params = seeded_params(WIDTH, N)
    net = seeded_net(params, WIDTH)
    style = seeded_style(net.encoder.out_channels)
    rng = np.random.default_rng(2)
    holo = (rng.random((BATCH, 1, N, N)) + 0.05).astype(np.float32)
    scales = quant.calibrate_scales(net, [np.sqrt(holo)], *style, device="cpu")
    tmp = tmp_path_factory.mktemp("export")
    paths = {}
    for path, kw in (("fp32", {}), ("bf16", {"dtype": torch.bfloat16}),
                     ("int8", {"quant_scales": scales}), ("suite", {"batch_size": SUITE_BATCH})):
        paths[path] = str(tmp / f"{path}.hstx")
        save_artifact(paths[path], *export_retrieval(
            net, style, CFG, platforms=("cpu",), **{"batch_size": BATCH, **kw}))
    return {"params": params, "net": net, "style": style, "holo": holo, "scales": scales,
            "paths": paths}


def _live(setup, holo, **kw):
    out = make_retrieval_fn(CFG.physics, device="cpu", **kw)(setup["net"], holo, *setup["style"], D_STYLE)
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("path", ["fp32", "bf16", "int8"])
def test_artifact_equals_the_live_path_bit_for_bit(setup, path):
    kw = {"fp32": {}, "bf16": {"dtype": torch.bfloat16}, "int8": {"quant_scales": setup["scales"]}}[path]
    art = load_artifact(setup["paths"][path], device="cpu")
    assert art.meta["format"] == "torch.export" and art.meta["platforms"] == ["cpu"]
    assert art.meta["dtype"] == ("float32" if path == "fp32" else "bfloat16")
    assert art.meta["quantized"] == (path == "int8") and art.meta["ops"] == []
    got = art.retrieve(setup["holo"])
    want = _live(setup, setup["holo"], **kw)
    assert list(got) == list(server._RESULT_KEYS)
    for k in want:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], want[k]), k


def test_fp32_artifact_matches_the_jax_program(setup):
    art = load_artifact(setup["paths"]["fp32"], device="cpu")
    got = art.retrieve(setup["holo"])
    jcfg = JConfig()
    ref = jfr.make_retrieval_fn(jcfg.physics, width=WIDTH)(
        setup["params"], jnp.asarray(setup["holo"]), *map(jnp.asarray, setup["style"]),
        float(jcfg.physics.to_network_units(jcfg.data.style_distances[0])))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    assert np.abs(got["amp_foc"] - ref["amp_foc"]).max() < 1e-4 * np.abs(ref["amp_foc"]).max()
    assert np.abs(got["distance_pred"] - ref["distance_pred"]).max() < 1e-4
    zm = lambda x: x - x.mean(axis=(-2, -1), keepdims=True)  # noqa: E731
    dph = zm(got["ph_foc"]) - zm(ref["ph_foc"])
    miss = np.abs(dph) >= 1e-4
    assert miss.mean() <= 1e-4
    if miss.any():  # a tie of the unwrap's congruence snap: whole cycles
        cycles = dph[miss] / (2 * math.pi)
        assert np.abs(cycles - np.round(cycles)).max() < 1e-4 / (2 * math.pi) + 1e-6


def test_results_are_the_servers_keys():
    assert export_artifact._RESULT_KEYS is server._RESULT_KEYS
    assert export_artifact.run_chunked is server.run_chunked


@pytest.mark.parametrize("b", [1, 3, 5])
def test_requests_are_padded_and_chunked(setup, b):
    art = load_artifact(setup["paths"]["fp32"], device="cpu")
    holo = (np.random.default_rng(b).random((b, 1, N, N)) + 0.05).astype(np.float32)
    got = art.retrieve(holo[:, 0] if b == 1 else holo)  # (B, S, S) is promoted
    padded = np.concatenate([holo, np.repeat(holo[-1:], -b % BATCH, axis=0)])
    for lo in range(0, b, BATCH):
        want = _live(setup, padded[lo : lo + BATCH])
        n = min(BATCH, b - lo)
        for k, v in want.items():
            assert got[k].shape[0] == b and np.array_equal(got[k][lo : lo + n], v[:n]), k
    with pytest.raises(ValueError, match="expected"):
        art.retrieve(np.zeros((2, 1, 64, 64), np.float32))
    with pytest.raises(ValueError, match="expected"):
        art.retrieve(np.zeros((0, 1, N, N), np.float32))


def test_a_bad_magic_is_refused(tmp_path):
    p = tmp_path / "junk.hstx"
    p.write_bytes(b"NOTANART" + b"\0" * 64)
    with pytest.raises(ValueError, match="bad magic"):
        load_artifact(str(p), device="cpu")


def test_a_jax_artifact_is_refused(tmp_path):
    """The JAX package's container with its header keys (export_artifact.py
    :147-158 there) and no ``format``: refused before its blob is read."""
    meta = {"batch_size": 2, "image_size": 128, "platforms": ["cpu", "tpu"],
            "style_distance_mm": 0.2, "quantized": False, "dtype": "float32", "width": 1.0,
            "asm_backend": "xla", "result_keys": list(server._RESULT_KEYS), "config": "{}"}
    p = str(tmp_path / "jax.hstx")
    save_artifact(p, b"stablehlo bytes", meta)
    assert read_artifact(p) == (meta, b"stablehlo bytes")
    with pytest.raises(ValueError, match="JAX"):
        load_artifact(p, device="cpu")


def test_cuda_is_refused_without_a_card(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net, style = setup["net"], setup["style"]
    for kw in ({"asm_backend": "cuda"}, {"platforms": ("cpu", "cuda")}):
        with pytest.raises(RuntimeError, match="CUDA card"):
            export_retrieval(net, style, CFG, batch_size=BATCH, **kw)
    with pytest.raises(RuntimeError, match="CUDA card"):
        load_artifact(setup["paths"]["fp32"])
    with pytest.raises(ValueError, match="asm_backend"):
        export_retrieval(net, style, CFG, batch_size=BATCH, asm_backend="pallas")


_CLEAN_LOAD = """
import json, sys
import numpy as np
from style_transfer_based_holographic_imaging_tpu_torch.pipelines.export_artifact import load_artifact
out = load_artifact(sys.argv[1], device="cpu").retrieve(np.full((3, 1, 128, 128), 0.3, np.float32))
port = "style_transfer_based_holographic_imaging_tpu_torch."
mods = [m[len(port):] for m in sys.modules if m.startswith(port)]
print(json.dumps({"shapes": {k: list(v.shape) for k, v in out.items()},
                  "jax": any(m == "jax" or m.startswith("jax.") for m in sys.modules),
                  "model_code": [m for m in mods
                                 if m.startswith("models") or m == "pipelines.field_retrieval"]}))
"""


def test_a_fresh_process_loads_without_model_code(setup):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    done = subprocess.run([sys.executable, "-c", _CLEAN_LOAD, setup["paths"]["fp32"]],
                          capture_output=True, text=True, timeout=300, env=env, check=True)
    report = json.loads(done.stdout.strip().splitlines()[-1])
    assert report["shapes"]["ph_foc"] == [3, 1, 128, 128]
    assert report["jax"] is False and report["model_code"] == []


def test_golden_suite_through_the_artifact(setup):
    art = load_artifact(setup["paths"]["suite"], device="cpu")
    suite = load_golden_suite()
    got = evaluate_golden_suite(None, suite, CFG, style_override=setup["style"], device="cpu",
                                retrieval_fn=lambda net, holo, sm, ss, d: art.retrieve(holo.numpy()))
    want = evaluate_golden_suite(setup["net"], suite, CFG, style_override=setup["style"], device="cpu")
    assert got == want


def test_artifact_service_over_http(setup):
    svc = ArtifactService(setup["paths"]["fp32"], device="cpu")
    svc.warmup()
    assert svc.n_served == 0
    box, bound = {}, threading.Event()
    t = threading.Thread(target=serve_forever, args=(svc, "127.0.0.1", 0), daemon=True,
                         kwargs={"ready": lambda h: (box.setdefault("h", h), bound.set())})
    t.start()
    try:
        assert bound.wait(30)
        url = f"http://127.0.0.1:{box['h'].server_address[1]}"
        got = retrieve_remote(url, setup["holo"][:1])
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            health = json.loads(r.read())
    finally:
        if "h" in box:
            box["h"].shutdown()
        t.join(30)
    want = svc.retrieve(setup["holo"][:1])
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert set(health) == {"status", "device", "artifact", "platforms", "batch_size", "image_size",
                           "width", "quantized", "refine_steps", "n_served"}
    assert health["artifact"] == setup["paths"]["fp32"] and health["platforms"] == ["cpu"]
    assert health["n_served"] == 1 and svc.n_served == 2 and health["width"] == WIDTH
