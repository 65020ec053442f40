"""The port stands alone: it imports neither JAX nor the JAX package, and
``chip_smoke.py`` refuses to report a result without a CUDA card."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest

import style_transfer_based_holographic_imaging_tpu_torch as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.dirname(port.__file__)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "style_transfer_based_holographic_imaging_tpu")


def _port_modules():
    return sorted(
        m.name
        for m in pkgutil.walk_packages([PORT_DIR], prefix=port.__name__ + ".")
    )


def _sources():
    paths = [
        os.path.join(root, name)
        for root, _, files in os.walk(PORT_DIR)
        for name in files
        if name.endswith(".py")
    ]
    return sorted(paths) + [os.path.join(REPO, "chip_smoke.py")]


def test_every_module_imports_with_jax_blocked():
    modules = [port.__name__] + _port_modules()
    assert len(modules) > 20
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'orbax.checkpoint',"
        " 'style_transfer_based_holographic_imaging_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import importlib, runpy\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        f"spec = importlib.util.spec_from_file_location('chip_smoke', {os.path.join(REPO, 'chip_smoke.py')!r})\n"
        "mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items() if v is not None)\n"
        "print('imported', len(sys.modules))\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert res.returncode == 0, res.stderr[-4000:]
    assert "imported" in res.stdout


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_import(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    bad = [
        n for n in names
        if n.split(".")[0] in FORBIDDEN and not n.startswith(port.__name__)
    ]
    assert not bad, f"{path} imports {bad}"


def test_chip_smoke_fails_without_a_card():
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    lone = tmp_path / "chip_smoke.py"
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        lone.write_text(f.read())
    res = subprocess.run(
        [sys.executable, str(lone)], cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"},
    )
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
