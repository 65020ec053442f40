"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``kernels/csrc`` is compiled, at first use, into a shared
library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu

The library's name carries a hash of the source and the flags, so an edit
rebuilds and a stale library is never loaded. ``nvcc`` writes to a temporary
name that is renamed into place when the build succeeds: a build that was
cut off leaves no partial library under the final name, and
``remove_stale`` deletes what such a build left. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["build", "load", "remove_stale", "kill_build", "BUILD_DIR", "CSRC_DIR"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
_BUILD_TIMEOUT_S = 240.0

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_running: subprocess.Popen | None = None


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise FileNotFoundError("nvcc not found on PATH or under $CUDA_HOME/bin")


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")


def remove_stale() -> list[str]:
    """Delete lock files and partial outputs left by a build that was cut off."""
    removed = []
    for pattern in ("*.tmp*", "lock", "*.lock"):
        for path in glob.glob(os.path.join(BUILD_DIR, pattern)):
            os.remove(path)
            removed.append(path)
    return removed


def kill_build() -> None:
    """Kill the ``nvcc`` this process started, if it is still running."""
    if _running is not None and _running.poll() is None:
        _running.kill()


def build(name: str) -> float:
    """Compile ``csrc/<name>.cu`` unless its library exists; the seconds taken.

    A failed or timed-out build raises with the compiler's output.
    """
    global _running
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = _lib_path(name)
    t0 = time.perf_counter()
    if os.path.isfile(out):
        return 0.0
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    _running = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        log, _ = _running.communicate(timeout=_BUILD_TIMEOUT_S)
        if _running.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu (exit {_running.returncode}):\n{log}")
        os.replace(tmp, out)
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"nvcc timed out after {_BUILD_TIMEOUT_S:.0f} s on {name}.cu") from None
    finally:
        kill_build()
        _running.wait()
        _running = None
        if os.path.exists(tmp):
            os.remove(tmp)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = _lib_path(name)
            if not os.path.isfile(path):
                build(name)
            lib = ctypes.CDLL(path)
            _loaded[name] = lib
        return lib
