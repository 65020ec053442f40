"""The kernel build's cache key (``kernels/_build.py``): a library's name
hashes its source and every local header that source includes, so an edit of
a shared header rebuilds every library that includes it."""

import os

from style_transfer_based_holographic_imaging_tpu_torch.kernels import _build


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


def test_lib_path_changes_with_an_included_header(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    _write(tmp_path / "a.cu", '#include "tile.cuh"\n#include <cuda_runtime.h>\nint a;\n')
    _write(tmp_path / "b.cu", 'int b;\n')
    _write(tmp_path / "tile.cuh", '#pragma once\n#include "inner.cuh"\nint t;\n')
    _write(tmp_path / "inner.cuh", "int i;\n")
    a0, b0 = _build._lib_path("a"), _build._lib_path("b")
    assert a0 == _build._lib_path("a")
    assert os.path.dirname(a0) == _build.BUILD_DIR and os.path.basename(a0).startswith("liba-")

    _write(tmp_path / "tile.cuh", '#pragma once\n#include "inner.cuh"\nint t2;\n')
    a1 = _build._lib_path("a")
    assert a1 != a0 and _build._lib_path("b") == b0

    _write(tmp_path / "inner.cuh", "int i2;\n")  # included by the header, not by the source
    assert _build._lib_path("a") not in (a0, a1)


def test_every_source_hashes_its_shared_header():
    """``conv_stack.cu`` and ``halo_conv.cu`` share ``conv_tile.cuh``."""
    header = os.path.join(_build.CSRC_DIR, "conv_tile.cuh")
    with open(header, "rb") as f:
        body = f.read()
    for name in ("conv_stack", "halo_conv"):
        text = _build._source_text(os.path.join(_build.CSRC_DIR, f"{name}.cu"), set())
        assert body in text
    for name in _build.SOURCES:
        assert os.path.isfile(os.path.join(_build.CSRC_DIR, f"{name}.cu"))
