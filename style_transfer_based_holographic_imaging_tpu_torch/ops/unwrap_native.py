"""ctypes binding to the native reliability-sort phase unwrapper (port of the
JAX ``ops/unwrap_native.py``): ``native/libunwrap.so``, built from
``native/unwrap.cc``.

``unwrap_phase_native`` takes the ``(..., H, W)`` batched signature of
``ops.unwrap.unwrap_phase`` and runs on the host. It is the golden oracle of
the DCT unwrap's tests and a path-following unwrap for pathologically
wrapped measured phases (the role skimage plays for the reference).

The committed library is loaded by its path. The port never writes into
``native/``: if that library does not load, ``unwrap.cc`` is built with
``g++`` into the port's git-ignored ``kernels/build/`` (named by the
source's hash) and that copy is loaded. If both fail,
``unwrap_phase_native`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from style_transfer_based_holographic_imaging_tpu_torch.kernels._build import BUILD_DIR

__all__ = ["unwrap_phase_native", "native_available"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "unwrap.cc")
_LIB = os.path.join(_REPO_ROOT, "native", "libunwrap.so")

_lock = threading.Lock()
_lib = None
_error = None


def _bind(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.unwrap2d_batch.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    lib.unwrap2d_batch.restype = ctypes.c_int
    return lib


def _build_copy() -> str:
    """``unwrap.cc`` built with g++ into BUILD_DIR (a temporary name, then
    renamed), unless that build exists; returns its path."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"libunwrap-{digest}.so")
    if not os.path.isfile(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.tmp{os.getpid()}"
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    return out


def _load():
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            _lib = _bind(_LIB)
        except OSError as committed:
            try:
                _lib = _bind(_build_copy())
            except (OSError, subprocess.CalledProcessError) as built:
                detail = getattr(built, "stderr", "") or built
                _error = f"{_LIB}: {committed}; building {_SRC}: {detail}"
        return _lib


def native_available() -> bool:
    return _load() is not None


def unwrap_phase_native(phase) -> np.ndarray:
    """Unwrap ``(..., H, W)`` wrapped phases on the host (float32 numpy in any
    form; a tensor on the card is copied to the host)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native unwrap unavailable: {_error}")
    if hasattr(phase, "detach"):
        phase = phase.detach().cpu().numpy()
    x = np.ascontiguousarray(np.asarray(phase, np.float32))
    h, w = x.shape[-2], x.shape[-1]
    batch = int(np.prod(x.shape[:-2], dtype=np.int64)) if x.ndim > 2 else 1
    flat = x.reshape(batch, h, w)
    out = np.empty_like(flat)
    rc = lib.unwrap2d_batch(flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), batch, h, w,
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise RuntimeError(f"unwrap2d_batch failed with code {rc}")
    return out.reshape(x.shape)
