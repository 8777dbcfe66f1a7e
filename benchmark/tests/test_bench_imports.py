"""No module of the benchmark imports JAX or the JAX package (compared by
whole top-level names: the port's name begins with the JAX package's), and
the plain reference imports nothing of the port."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark import harness

MODULES = sorted(
    os.path.relpath(os.path.join(d, f), harness.ROOT)
    for d, _, files in os.walk(harness.BENCH_DIR) for f in files if f.endswith(".py"))


def imported(path):
    with open(os.path.join(harness.ROOT, path)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", MODULES)
def test_no_jax(path):
    assert not set(imported(path)) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", [p for p in MODULES if "/reference/" in p])
def test_reference_stands_alone(path):
    assert "raycastworlds_tpu_torch" not in set(imported(path))
    assert not set(imported(path)) & {"benchmark"}


def test_loaded_modules():
    """Importing every module of the benchmark and the port loads none."""
    mods = [p[:-3].replace(os.sep, ".") for p in MODULES if not p.endswith("conftest.py")
            and "/tests/" not in p and not p.endswith("run.py")]
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import raycastworlds_tpu_torch\n"
            "from benchmark import harness\n"
            "print(harness.forbidden_loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, check=True).stdout
    assert out.strip() == "[]"


def test_forbidden_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "raycastworlds_tpu_torch_x", sys)
    assert "raycastworlds_tpu_torch_x" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "raycastworlds_tpu.env", sys)
    assert "raycastworlds_tpu.env" in harness.forbidden_loaded()
