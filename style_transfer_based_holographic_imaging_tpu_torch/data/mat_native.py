"""ctypes binding to the native MAT-v5 reader (``native/libmatio.so``, built
from ``native/matio.cc``), the JAX package's ``data/mat_native.py``.

The library is loaded by path from the repo root. It reads a real 2D
numeric variable of a level-5 MAT file; for anything outside that subset
``read_mat_2d`` returns None and the caller reads through ``scipy.io``.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

__all__ = ["native_available", "read_mat_2d"]

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_LIB_PATH = os.path.join(_REPO_ROOT, "native", "libmatio.so")
_lib = None


def _load():
    global _lib
    if _lib is None and os.path.isfile(_LIB_PATH):
        lib = ctypes.CDLL(_LIB_PATH)
        lib.mat_read2d.restype = ctypes.c_int
        lib.mat_read2d.argtypes = [
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def read_mat_2d(path: str, var: str) -> Optional[np.ndarray]:
    """Read a real 2D numeric MAT-v5 variable as float64 (row-major).

    Returns None when the native library is missing or the file/variable
    falls outside the supported subset (caller falls back to scipy).
    """
    lib = _load()
    if lib is None:
        return None
    rows = ctypes.c_int64(0)
    cols = ctypes.c_int64(0)
    rc = lib.mat_read2d(
        path.encode(), var.encode(), None, ctypes.byref(rows), ctypes.byref(cols)
    )
    if rc != 0 or rows.value <= 0 or cols.value <= 0:
        return None
    out = np.empty((rows.value, cols.value), np.float64)
    rc = lib.mat_read2d(
        path.encode(),
        var.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.byref(rows),
        ctypes.byref(cols),
    )
    if rc != 0:
        return None
    return out
