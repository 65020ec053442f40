"""Frozen serving artifacts: the whole retrieval program in one file (port of
the JAX package's ``pipelines/export_artifact.py``).

``export_retrieval`` freezes what ``RetrievalService`` runs, sqrt -> VGG
encode -> AdaIN -> decode -> distance head -> ASM refocus -> DCT unwrap,
with ``torch.export``: the weights, the style vector and the static refocus
distance (in network units) baked in, at one NCHW batch shape, on the fp32,
bf16 or int8 path. The file

* needs no model code to run: ``load_artifact`` imports ``torch`` and, when
  the graph calls the hand-written kernels, their op registrations
  (``kernels``), and nothing of ``models`` or ``field_retrieval``;
* holds one ``ExportedProgram`` a device (``platforms``, ``"cpu"`` and
  ``"cuda"``), each traced on its device; the load picks the one of the
  device it is asked for;
* pins the numerics: the program is the aten graph of the live function,
  without decompositions, so the artifact answers as the live path does.

The ASM backend (JAX ``asm_backend``): ``"torch"`` exports the portable
``torch.fft`` composition (JAX ``"xla"``); ``"cuda"`` exports the refocus
as the op ``holostyle::asm_const`` (JAX ``"pallas"``), which exists on the
card alone, so it forces ``platforms=("cuda",)``. With the fused stacks on
(``models.quant.set_fused_stacks``) an int8 export holds the head and tail
ops too; ``meta["ops"]`` lists every ``holostyle`` op a program calls.

File format (the JAX package's container): ``HSTXPRT1`` magic, an 8-byte
little-endian header length, a JSON header, then the blob. The header keeps
the JAX package's keys and adds ``"format": "torch.export"`` and
``"programs"``, each device's ``[offset, length]`` in the blob. A header
without ``"format"`` is a JAX (StableHLO) artifact, which the port refuses.

CLI: ``cli export --checkpoint ... --out model.hstx`` to freeze (``--check``
scores the written file on the golden suite) and ``cli serve --artifact
model.hstx`` to serve it.
"""

from __future__ import annotations

import copy
import io
import json
import struct
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from style_transfer_based_holographic_imaging_tpu_torch.config import ExperimentConfig
from style_transfer_based_holographic_imaging_tpu_torch.pipelines.server import (
    _RESULT_KEYS,
    run_chunked,
)

__all__ = [
    "export_retrieval",
    "save_artifact",
    "load_artifact",
    "read_artifact",
    "ArtifactRetrieval",
]

_MAGIC = b"HSTXPRT1"
_FORMAT = "torch.export"
_PLATFORMS = ("cpu", "cuda")
_ASM_BACKENDS = ("torch", "cuda")


def _require_card(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} needs a CUDA card, and there is none: use the CPU "
                           f"('cpu' among the platforms, device='cpu')")


class _Program(torch.nn.Module):
    """The served retrieval at one batch shape: holograms in, the result
    dict out. The style statistics are buffers; the refocus distance and
    every option are constants of the trace."""

    def __init__(self, net, sm, ss, d_style: float, config: ExperimentConfig, **kw):
        super().__init__()
        self.net = net
        self.register_buffer("sm", sm)
        self.register_buffer("ss", ss)
        self._d_style = d_style
        self._config = config
        self._kw = kw

    def forward(self, holo: torch.Tensor) -> Dict[str, torch.Tensor]:
        from style_transfer_based_holographic_imaging_tpu_torch.pipelines.field_retrieval import (
            retrieval_step,
        )

        out = retrieval_step(self.net, holo, self.sm, self.ss, self._d_style,
                             self._config.physics, alpha=self._config.eval.alpha, **self._kw)
        return {k: out[k] for k in _RESULT_KEYS if k in out}


def export_retrieval(
    net,
    style_vector: Tuple[np.ndarray, np.ndarray],
    config: Optional[ExperimentConfig] = None,
    *,
    batch_size: int = 32,
    dtype: Optional[torch.dtype] = None,
    quant_scales: Optional[Dict[str, float]] = None,
    style_distance: Optional[float] = None,
    platforms: Optional[Tuple[str, ...]] = _PLATFORMS,
    asm_backend: str = "torch",
) -> Tuple[bytes, dict]:
    """Export the fixed-shape retrieval program of ``net`` (a
    ``StyleTransferNet``); returns ``(blob, meta)`` for ``save_artifact``.

    The program is ``RetrievalService``'s: the style plane's distance in
    network units (``style_distance`` mm, the config's first style distance
    when None) as a host float, so the refocus is the constant-distance
    one; ``dtype`` and ``quant_scales`` as ``retrieval_step`` takes them.
    ``platforms`` names the devices to trace on (None: the net's own); a
    ``"cuda"`` without a card raises. ``asm_backend="cuda"`` exports the
    ``asm_const`` op and forces ``("cuda",)``. The caller's net is not
    moved: each device traces its own copy.
    """
    from style_transfer_based_holographic_imaging_tpu_torch.kernels import library
    from style_transfer_based_holographic_imaging_tpu_torch.models.net import style_stats_nchw

    cfg = config or ExperimentConfig()
    if asm_backend not in _ASM_BACKENDS:
        raise ValueError(f"asm_backend must be one of {_ASM_BACKENDS}, got {asm_backend!r}")
    if asm_backend == "cuda":
        platforms = ("cuda",)
    elif platforms is None:
        platforms = (next(net.parameters()).device.type,)
    platforms = tuple(platforms)
    unknown = [p for p in platforms if p not in _PLATFORMS]
    if unknown or not platforms:
        raise ValueError(f"platforms must name some of {_PLATFORMS}, got {platforms}")
    if "cuda" in platforms:
        _require_card("exporting for 'cuda'")

    image_size = int(cfg.model.image_size)
    d_s_mm = cfg.data.style_distances[0] if style_distance is None else style_distance
    d_style = float(cfg.physics.to_network_units(d_s_mm))
    kw = dict(dtype=dtype, quant_scales=quant_scales, asm_backend=asm_backend)
    blob, programs, ops = io.BytesIO(), {}, set()
    for platform in platforms:
        dev = torch.device(platform)
        f32 = dict(dtype=torch.float32, device=dev)
        sm = style_stats_nchw(torch.as_tensor(np.asarray(style_vector[0]), **f32))
        ss = style_stats_nchw(torch.as_tensor(np.asarray(style_vector[1]), **f32))
        program = _Program(copy.deepcopy(net).to(dev).eval(), sm, ss, d_style, cfg,
                           device=dev, **kw)
        example = torch.full((batch_size, 1, image_size, image_size), 0.1, **f32)
        exported = torch.export.export(program, (example,))
        ops.update(library.graph_ops(exported.graph))
        part = io.BytesIO()
        torch.export.save(exported, part)
        programs[platform] = [blob.tell(), len(part.getvalue())]
        blob.write(part.getvalue())
    meta = {
        "format": _FORMAT,
        "batch_size": batch_size,
        "image_size": image_size,
        "platforms": list(platforms),
        "programs": programs,
        "ops": sorted(ops),
        "style_distance_mm": float(d_s_mm),
        "quantized": quant_scales is not None,
        # the compute dtype: the int8 path's is bf16 unless named
        "dtype": str(dtype or (torch.bfloat16 if quant_scales is not None else torch.float32)
                     ).replace("torch.", ""),
        "width": net.width,
        "asm_backend": asm_backend,
        "result_keys": list(_RESULT_KEYS),
        "torch": torch.__version__,
        "config": cfg.to_json(),
    }
    return blob.getvalue(), meta


def save_artifact(path: str, blob: bytes, meta: dict) -> None:
    header = json.dumps(meta).encode("utf-8")
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(header)))
        f.write(header)
        f.write(blob)


@dataclass
class ArtifactRetrieval:
    """A loaded artifact: ``meta``, the device's program, and a padded,
    chunked ``retrieve``."""

    meta: dict
    device: torch.device
    _module: torch.nn.Module

    @torch.inference_mode()
    def __call__(self, holo: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Raw call at the exported batch size (tensors on ``device``)."""
        return self._module(holo)

    def retrieve(self, holo: np.ndarray) -> Dict[str, np.ndarray]:
        """Run ``(B, 1, S, S)`` intensity holograms for any B >= 1, padding
        and chunking to the exported batch (the server's contract); host
        fp32 arrays out."""
        def run(chunk):
            out = self(torch.from_numpy(chunk).to(self.device))
            return {k: v.float().cpu().numpy() for k, v in out.items()}

        return run_chunked(holo, int(self.meta["batch_size"]), int(self.meta["image_size"]), run)


def read_artifact(path: str) -> Tuple[dict, bytes]:
    """``(meta, blob)`` of a ``save_artifact`` file; a bad magic raises."""
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"{path}: not a retrieval artifact (bad magic)")
        (hlen,) = struct.unpack("<Q", f.read(8))
        meta = json.loads(f.read(hlen).decode("utf-8"))
        return meta, f.read()


def load_artifact(path: str, device: str | torch.device = "cuda") -> ArtifactRetrieval:
    """Load a ``save_artifact`` file's program for ``device`` (the card
    unless the caller asks for the CPU). Needs ``torch`` and, for a graph
    that calls them, the kernels' op registrations; no model code. A JAX
    artifact, or one without a program for ``device``, raises."""
    device = torch.device(device)
    if device.type == "cuda":
        _require_card("loading an artifact on 'cuda'")
    meta, blob = read_artifact(path)
    if meta.get("format") != _FORMAT:
        raise ValueError(
            f"{path}: a JAX (jax.export / StableHLO) artifact, which the port cannot run: "
            f"export it again with the port ('cli export')")
    if device.type not in meta["programs"]:
        raise ValueError(f"{path}: exported for {meta['platforms']}, not {device.type!r}")
    if meta["ops"]:
        import style_transfer_based_holographic_imaging_tpu_torch.kernels  # noqa: F401  (registers the ops)
    offset, length = meta["programs"][device.type]
    program = torch.export.load(io.BytesIO(blob[offset : offset + length]))
    return ArtifactRetrieval(meta, device, program.module())
