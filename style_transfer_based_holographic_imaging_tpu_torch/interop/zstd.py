"""Zstandard decoding and CRC-32C through ``csrc/zstd_decode.cc``.

The decoder is the port's own (RFC 8878, no dictionaries): the orbax
releases' OCDBT nodes and zarr chunks are zstd frames, and the card machine
has no zstd library. Its library is built at first use by the host C++
compiler into ``kernels/build/``, under a name that hashes the source and
the flags (``kernels/_build.py``, ``HOST_SOURCES``), and loaded with
``ctypes``. A missing compiler, a failed build or a frame that does not
decode raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from style_transfer_based_holographic_imaging_tpu_torch.kernels import _build

__all__ = ["decompress", "decompress_into", "crc32c", "ZstdError"]

_NAME = "zstd_decode"
_lib: Optional[ctypes.CDLL] = None


class ZstdError(ValueError):
    """A frame that does not decode (corrupt, truncated, or needing a
    dictionary)."""


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load(_NAME)
        lib.zstd_decode.restype = ctypes.c_longlong
        lib.zstd_decode.argtypes = (ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t)
        lib.zstd_error_name.restype = ctypes.c_char_p
        lib.zstd_error_name.argtypes = (ctypes.c_longlong,)
        lib.zstd_error_dst_too_small.restype = ctypes.c_longlong
        lib.crc32c.restype = ctypes.c_uint32
        lib.crc32c.argtypes = (ctypes.c_char_p, ctypes.c_size_t)
        _lib = lib
    return _lib


def _error(lib, code: int) -> "ZstdError":
    return ZstdError(f"zstd: {lib.zstd_error_name(code).decode()}")


def decompress(data: bytes, size: Optional[int] = None, *, max_size: int = 1 << 31) -> bytes:
    """The content of the zstd frames in ``data``. With ``size`` the content
    must be exactly ``size`` bytes; without it the output buffer grows,
    doubling, up to ``max_size``."""
    lib = _library()
    data = bytes(data)
    cap = size if size is not None else min(max(4 * len(data), 1 << 16), max_size)
    while True:
        buf = ctypes.create_string_buffer(max(cap, 1))
        n = lib.zstd_decode(data, len(data), buf, cap)
        if n == lib.zstd_error_dst_too_small() and size is None and cap < max_size:
            cap = min(2 * cap, max_size)
            continue
        break
    if n < 0:
        raise _error(lib, n)
    if size is not None and n != size:
        raise ZstdError(f"zstd: decoded {n} bytes, expected {size}")
    return buf.raw[:n]


def decompress_into(data: bytes, out: np.ndarray) -> None:
    """Decode the zstd frames in ``data`` into the C-contiguous array
    ``out``, whose bytes they must fill exactly."""
    if not (out.flags.c_contiguous and out.flags.writeable):
        raise ValueError("out must be a writable C-contiguous array")
    lib = _library()
    data = bytes(data)
    n = lib.zstd_decode(data, len(data), out.ctypes.data, out.nbytes)
    if n < 0:
        raise _error(lib, n)
    if n != out.nbytes:
        raise ZstdError(f"zstd: decoded {n} bytes, expected {out.nbytes}")


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    data = bytes(data)
    return int(_library().crc32c(data, len(data)))
