"""HTTP serving daemon around the retrieval pipeline (port of the JAX
package's ``pipelines/server.py``).

A long-lived process that keeps the weights resident on the card and
answers retrieval requests over the wire:

* **Fixed batch shape.** Requests of any size are padded up or chunked to
  the service's batch size (``run_chunked``), so every call of the net sees
  one shape.
* **One device owner.** A single lock serializes the card's work; the
  stdlib ``ThreadingHTTPServer`` handles sockets and (de)serialization
  concurrently outside the lock.
* **npz in, npz out.** Requests carry a ``holo`` array ``(B, 1, H, W)`` of
  intensity holograms; responses carry ``_RESULT_KEYS``, fp32.

The refocus distance is the style plane's, kept as a host float: the
refocus is the constant-transfer-function kernel (``asm_const``). With
``refine_steps`` every chunk is refined against its holograms
(``pipelines.refine.refine_retrieval``), whose steps launch ``asm_dynamic``.

Endpoints:
  GET  /healthz   -> JSON status (device, batch shape, quant/refine config)
  POST /retrieve  -> npz body with ``holo`` -> npz response

Start from the CLI::

  python -m style_transfer_based_holographic_imaging_tpu_torch.cli serve \\
      --checkpoint checkpoints/fast --port 8100
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import TYPE_CHECKING, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from style_transfer_based_holographic_imaging_tpu_torch.config import ExperimentConfig

if TYPE_CHECKING:
    from style_transfer_based_holographic_imaging_tpu_torch.models.net import StyleTransferNet

__all__ = [
    "RetrievalService",
    "ArtifactService",
    "serve_forever",
    "retrieve_remote",
    "run_chunked",
]

# The serving result contract: the response's keys and a frozen artifact's
# outputs (``pipelines/export_artifact.py`` imports it). The model code is
# imported by ``RetrievalService`` alone, so that an artifact loads and
# serves without it.
_RESULT_KEYS = ("amp_foc", "ph_foc", "distance_pred", "amp_field", "ph_field")


def run_chunked(
    holo: np.ndarray, batch_size: int, image_size: int, run
) -> Dict[str, np.ndarray]:
    """Validate (B, 1, S, S) holograms, pad the ragged tail with its last
    frame, run ``run`` per batch-size chunk, trim and concatenate.

    The one batching contract of the live server and of frozen artifacts
    (``ArtifactRetrieval``), so the padding and chunking seen over the wire
    cannot diverge.
    """
    holo = np.asarray(holo, np.float32)
    if holo.ndim == 3:
        holo = holo[:, None]
    if (
        holo.ndim != 4
        or holo.shape[0] == 0
        or holo.shape[1] != 1
        or holo.shape[2:] != (image_size, image_size)
    ):
        raise ValueError(
            f"expected (B>=1, 1, {image_size}, {image_size}) intensity "
            f"holograms, got {holo.shape}"
        )
    n = holo.shape[0]
    outs = []
    for lo in range(0, n, batch_size):
        chunk = holo[lo : lo + batch_size]
        pad = batch_size - chunk.shape[0]
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad, axis=0)], axis=0)
        out = run(chunk)
        if pad:
            out = {k: v[: batch_size - pad] for k, v in out.items()}
        outs.append(out)
    if len(outs) == 1:
        return outs[0]
    return {k: np.concatenate([o[k] for o in outs], axis=0) for k in outs[0]}


def _device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


class ArtifactService:
    """A frozen export artifact (``pipelines/export_artifact.py``) behind the
    server's lock: ``RetrievalService``'s surface (``warmup``, ``retrieve``,
    ``health``, ``n_served``), so ``serve_forever`` takes either. The
    program, weights, style vector and refocus distance all come from the
    one file; the padding and chunking to its batch live in
    ``ArtifactRetrieval.retrieve``."""

    def __init__(self, path: str, device: str | torch.device = "cuda"):
        from style_transfer_based_holographic_imaging_tpu_torch.pipelines.export_artifact import (
            load_artifact,
        )

        self.path = path
        self._art = load_artifact(path, device)
        self.device = self._art.device
        self.meta = self._art.meta
        self.batch_size = int(self.meta["batch_size"])
        self.image_size = int(self.meta["image_size"])
        self._lock = threading.Lock()
        self.n_served = 0

    def warmup(self) -> None:
        """One request before the first one served (cuDNN's algorithm
        choice, the kernels' build)."""
        self.retrieve(np.full((1, 1, self.image_size, self.image_size), 0.1, np.float32))
        self.n_served = 0

    def retrieve(self, holo: np.ndarray) -> Dict[str, np.ndarray]:
        with self._lock:
            out = self._art.retrieve(holo)
            self.n_served += next(iter(out.values())).shape[0]
        return out

    def health(self) -> Dict:
        return {
            "status": "ok",
            "device": _device_name(self.device),
            "artifact": self.path,
            "platforms": self.meta.get("platforms"),
            "batch_size": self.batch_size,
            "image_size": self.image_size,
            "width": self.meta.get("width"),
            "quantized": self.meta.get("quantized"),
            "refine_steps": 0,
            "n_served": self.n_served,
        }


class RetrievalService:
    """The net's weights on the card and the retrieval fn, behind a lock.

    ``net`` is moved to ``device``. ``dtype`` is the fp net's compute dtype
    (fp32 when None; ``cli serve`` passes bf16 by default); ``quant_scales``
    serves the int8 path instead, in ``dtype`` (bf16 when None).

    With a ``mesh`` (``parallel.make_mesh``; ``device`` is then not read)
    the batch is split over its ``data`` axis, as the JAX package's single
    controller shards it: this process keeps a replica of the net and of
    the style vector on each mesh device, launches each chunk on the device
    of its ``data`` position (the first along the other axes) and
    concatenates the answers. Serving takes no gradient, so no collective;
    the batch size must divide by the axis.
    """

    def __init__(
        self,
        net: StyleTransferNet,
        style_vector: Tuple[np.ndarray, np.ndarray],
        config: Optional[ExperimentConfig] = None,
        *,
        batch_size: int = 32,
        dtype: Optional[torch.dtype] = None,
        quant_scales: Optional[Dict[str, float]] = None,
        refine_steps: int = 0,
        device: str | torch.device = "cuda",
        mesh=None,
    ):
        from style_transfer_based_holographic_imaging_tpu_torch.pipelines.field_retrieval import (
            retrieval_replicas,
        )
        from style_transfer_based_holographic_imaging_tpu_torch.pipelines.refine import (
            refine_retrieval,
        )

        self._refine = refine_retrieval
        self.config = config or ExperimentConfig()
        self.batch_size = int(batch_size)
        self.mesh = mesh
        if mesh is None:
            devices = [torch.device(device)]
        else:
            from style_transfer_based_holographic_imaging_tpu_torch.data.prefetch import data_devices
            from style_transfer_based_holographic_imaging_tpu_torch.parallel.mesh import (
                DATA_AXIS,
                batch_sharding,
            )

            if DATA_AXIS not in mesh.shape:
                raise ValueError(f"serving mesh axes {tuple(mesh.axis_names)} lack the batch "
                                 f"axis {DATA_AXIS!r}")
            if self.batch_size % mesh.shape[DATA_AXIS]:
                raise ValueError(f"batch_size {self.batch_size} must be divisible by the "
                                 f"'{DATA_AXIS}' mesh axis size ({mesh.shape[DATA_AXIS]})")
            devices = data_devices(batch_sharding(mesh))
        self.device = devices[0]
        self.image_size = int(self.config.model.image_size)
        self.refine_steps = int(refine_steps)
        self.quantized = quant_scales is not None
        # millimetres -> network units, as the training synthesizer does. A
        # host float: the refocus takes the constant-distance kernel.
        physics = self.config.physics
        self._d_style = float(physics.to_network_units(self.config.data.style_distances[0]))
        replicas = retrieval_replicas(net.to(self.device).eval(), style_vector, physics, devices,
                                      alpha=self.config.eval.alpha, dtype=dtype,
                                      quant_scales=quant_scales)
        self._chunks = [(dev, replicas[dev]) for dev in devices]
        self.net = self._chunks[0][1][0]
        self._lock = threading.Lock()
        self.n_served = 0

    def warmup(self) -> None:
        """One batch before the first request (cuDNN's algorithm choice,
        the kernels' build)."""
        self.retrieve(np.full((self.batch_size, 1, self.image_size, self.image_size), 0.1, np.float32))
        self.n_served = 0

    def _run_one(self, holo_np: np.ndarray) -> Dict[str, np.ndarray]:
        """One batch: each data position's chunk launched on its device, all
        before the first is read back, the chunks joined in order."""
        outs = []
        for (dev, (net, sm, ss, fn)), chunk in zip(self._chunks,
                                                   np.split(holo_np, len(self._chunks))):
            holo = torch.from_numpy(chunk).to(dev)
            out = fn(net, holo, sm, ss, self._d_style)
            if self.refine_steps:
                out = self._refine(out, holo, self.config.physics, steps=self.refine_steps, device=dev)
            outs.append(out)
        keys = [k for k in _RESULT_KEYS if k in outs[0]]
        return {k: np.concatenate([o[k].detach().float().cpu().numpy() for o in outs]) for k in keys}

    def retrieve(self, holo: np.ndarray) -> Dict[str, np.ndarray]:
        """Run retrieval on (B, 1, H, W) intensity holograms, any B >= 1.

        Chunks and pads to the batch size; returns host fp32 arrays trimmed
        back to the request's B.
        """
        with self._lock:
            out = run_chunked(holo, self.batch_size, self.image_size, self._run_one)
            self.n_served += next(iter(out.values())).shape[0]
        return out

    def health(self) -> Dict:
        return {
            "status": "ok",
            "device": _device_name(self.device),
            "batch_size": self.batch_size,
            "image_size": self.image_size,
            "width": self.net.width,
            "quantized": self.quantized,
            "refine_steps": self.refine_steps,
            "n_devices": 1 if self.mesh is None else self.mesh.size,
            "n_served": self.n_served,
        }


def _make_handler(service):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path in ("/healthz", "/health", "/"):
                self._send_json(200, service.health())
            else:
                self._send_json(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/retrieve":
                self._send_json(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                with np.load(io.BytesIO(self.rfile.read(length))) as z:
                    if "holo" not in z:
                        raise ValueError("npz must contain a 'holo' array")
                    holo = z["holo"]
            except Exception as e:  # noqa: BLE001 — malformed request
                self._send_json(400, {"error": str(e)})
                return
            try:
                out = service.retrieve(holo)
            except ValueError as e:  # bad shapes etc. — client's fault
                self._send_json(400, {"error": str(e)})
                return
            except Exception as e:  # noqa: BLE001 — server-side failure
                self._send_json(500, {"error": str(e)})
                return
            buf = io.BytesIO()
            np.savez_compressed(buf, **out)
            self._send(200, buf.getvalue(), "application/octet-stream")

    return Handler


def retrieve_remote(url: str, holo: np.ndarray, timeout: float = 120.0) -> Dict[str, np.ndarray]:
    """Client helper: POST (B, 1, H, W) intensity holograms to a running
    ``cli serve`` daemon and return its arrays. Stdlib and numpy only."""
    import urllib.request

    buf = io.BytesIO()
    np.savez_compressed(buf, holo=np.asarray(holo, np.float32))
    req = urllib.request.Request(url.rstrip("/") + "/retrieve", data=buf.getvalue(), method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return dict(np.load(io.BytesIO(r.read())))


def serve_forever(
    service,
    host: str = "127.0.0.1",
    port: int = 8100,
    *,
    ready: Optional[Callable[[ThreadingHTTPServer], None]] = None,
) -> ThreadingHTTPServer:
    """Start the HTTP server (blocking) for a ``RetrievalService`` or an
    ``ArtifactService``; returns only after ``shutdown()``.

    ``ready(httpd)`` is called once the socket is bound, before the first
    request is taken: with port 0 the port is ``httpd.server_address[1]``,
    and ``httpd.shutdown()`` from another thread ends the serve.
    """
    with ThreadingHTTPServer((host, port), _make_handler(service)) as httpd:
        if ready is not None:
            ready(httpd)
        httpd.serve_forever()
    return httpd
