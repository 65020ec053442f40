"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``kernels/csrc`` is compiled, at first use, into a shared
library of its own with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -split-compile=0 \
         -o build/lib<name>-<hash>.so csrc/<name>.cu

``-split-compile=0`` lets the compiler optimize a source's kernels on every
core at once: ``halo_conv.cu`` alone builds in 14.1 s instead of 42.2, all
four started together in 20.9 s instead of 39.1 (NVIDIA H100 80GB HBM3
host, 8 cores, nvcc 12.9).

The library's name carries a hash of the source, of the headers it
includes with ``#include "..."`` (found beside it, followed recursively), and
of the flags, so an edit of any of them rebuilds and a stale library is
never loaded. ``build`` starts one ``nvcc`` per named source, all at once,
and waits for them; the compiler's output (with ``-Xptxas -v``: each
kernel's registers, shared memory and spills) is kept in ``LOGS``. Each
writes to a
temporary name that is renamed into place when its build succeeds: a build
that was cut off leaves no partial library under the final name, and
``remove_stale`` deletes what such a build left. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

__all__ = [
    "build", "load", "remove_stale", "kill_build", "check_status", "SOURCES", "BUILD_DIR", "CSRC_DIR",
    "LOGS", "ptxas_lines",
]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-split-compile=0",
)
_BUILD_TIMEOUT_S = 240.0
# Every kernel source of the port, by name (csrc/<name>.cu).
SOURCES = ("asm_propagate", "conv_stack", "halo_conv", "reflect_border")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_running: dict[str, subprocess.Popen] = {}
# The compiler's output of each build this process ran, by source name.
LOGS: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise FileNotFoundError("nvcc not found on PATH or under $CUDA_HOME/bin")


_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def _source_text(path: str, seen: set) -> bytes:
    """The file's bytes followed by those of each local header it includes,
    each file once."""
    seen.add(path)
    with open(path, "rb") as f:
        text = f.read()
    parts = [text]
    for inc in _LOCAL_INCLUDE.findall(text):
        header = os.path.normpath(os.path.join(os.path.dirname(path), inc.decode()))
        if header not in seen and os.path.isfile(header):
            parts.append(_source_text(header, seen))
    return b"".join(parts)


def _lib_path(name: str) -> str:
    text = _source_text(os.path.join(CSRC_DIR, f"{name}.cu"), set())
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
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
    """Kill every ``nvcc`` this process started that is still running."""
    for proc in list(_running.values()):
        if proc.poll() is None:
            proc.kill()


def build(*names: str) -> dict[str, float]:
    """Compile ``csrc/<name>.cu`` for each name whose library does not exist,
    one ``nvcc`` per source, all started together, then wait for each in
    turn. Returns, for each name, the seconds from the start until its
    ``nvcc`` was seen done (0.0 for a library that was already built).
    Calls on other threads may build other names at the same time.

    A failed or timed-out build raises with the compiler's output.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    seconds = {name: 0.0 for name in names}
    started = {}
    try:
        for name in names:
            out = _lib_path(name)
            if os.path.isfile(out):
                continue
            tmp = f"{out}.tmp{os.getpid()}"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
            # The compiler's output goes to a file: a pipe nobody reads
            # while waiting could fill and stall nvcc.
            with open(f"{tmp}.log", "w") as log:
                _running[name] = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
            started[name] = (out, tmp)
        for name, (out, tmp) in started.items():
            proc = _running[name]
            try:
                proc.wait(timeout=max(_BUILD_TIMEOUT_S - (time.perf_counter() - t0), 0.0))
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"nvcc timed out after {_BUILD_TIMEOUT_S:.0f} s on {name}.cu") from None
            with open(f"{tmp}.log") as log:
                LOGS[name] = log.read()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{LOGS[name]}")
            os.replace(tmp, out)
            seconds[name] = time.perf_counter() - t0
    finally:
        # only this call's compilers: another thread's build runs on
        for name, (_, tmp) in started.items():
            proc = _running.pop(name)
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            for path in (tmp, f"{tmp}.log"):
                if os.path.exists(path):
                    os.remove(path)
    return seconds


def ptxas_lines(name: str) -> list[str]:
    """The ``-Xptxas -v`` lines of this process's build of ``name``: each
    kernel's entry, registers, shared memory, stack and spills, and any
    advice that its wgmma products were serialized."""
    keep = ("Compiling entry", "Used", "spill", "bytes stack frame", "Performance")
    return [line.strip() for line in LOGS.get(name, "").splitlines() if any(k in line for k in keep)]


def check_status(status: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {status}")


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
