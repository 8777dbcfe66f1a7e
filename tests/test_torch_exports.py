"""The port names everything the JAX package names.

* Every name a JAX ``__init__`` imports (the package and its ``models``,
  ``ops``, ``utils`` and ``parallel`` sub-packages) resolves in the port's
  counterpart.
* Every public def, class, method and module-level constant of each JAX
  module (``oracle/`` left out: only tests use it) exists in the port
  module of the same path, inherited methods and class attributes
  included, read by ``ast`` from the JAX source so no JAX module is
  imported for it.  The exceptions are listed with their reasons, and each
  must still be missing, so that the list stays exact.
"""

import ast
import importlib
import pathlib

import pytest

import raycastworlds_tpu_torch  # noqa: F401

JAX_ROOT = pathlib.Path(__file__).resolve().parents[1] / "raycastworlds_tpu"
PORT = "raycastworlds_tpu_torch"

# module path -> {name: why the port has no such name}
EXCEPTIONS = {
    "parallel/mesh.py": {
        "env_sharding": "a jax.sharding.NamedSharding of the env axis; the port "
                        "places a rank's rows with mesh.shard_env_state",
        "replicated": "a replicated jax.sharding.NamedSharding; a torch.distributed "
                      "rank holds replicated tensors as plain tensors",
    },
    "parallel/ppo.py": {
        "param_shardings": "a pytree of NamedShardings; the port shards params "
                           "with param_shard_dim / shard_params",
    },
    "ops/raycast.py": {
        "cast_rays_scan_flat": "the [B*R]-lane layout of the DDA is an XLA choice "
                               "with the scan's result; backend scan_flat runs "
                               "cast_rays_scan",
    },
}


def public_names(path: pathlib.Path):
    """Public module-level defs, classes and constants, and ``Class.method``
    for every public method or property of a public class."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            names.append(node.name)
            if isinstance(node, ast.ClassDef):
                names += [f"{node.name}.{m.name}" for m in node.body
                          if isinstance(m, ast.FunctionDef) and not m.name.startswith("_")]
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets
                      if isinstance(t, ast.Name) and not t.id.startswith("_")]
    return names


def resolves(module, dotted: str) -> bool:
    obj = module
    for part in dotted.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


def port_module(rel: pathlib.Path):
    parts = rel.with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return importlib.import_module(".".join((PORT,) + parts))


MODULES = sorted(str(p.relative_to(JAX_ROOT)) for p in JAX_ROOT.rglob("*.py")
                 if p.relative_to(JAX_ROOT).parts[0] != "oracle"
                 and p.name != "__init__.py")
INITS = ["__init__.py", "models/__init__.py", "ops/__init__.py", "utils/__init__.py",
         "parallel/__init__.py"]


@pytest.mark.parametrize("init", INITS)
def test_init_exports_resolve(init):
    """Every name the JAX __init__ imports (``from .x import a``, ``from .
    import m``) is an attribute of the port's package."""
    tree = ast.parse((JAX_ROOT / init).read_text())
    names = [a.asname or a.name for n in tree.body if isinstance(n, ast.ImportFrom)
             for a in n.names]
    assert names
    module = port_module(pathlib.Path(init))
    missing = [n for n in names if not hasattr(module, n)]
    assert not missing, f"{init}: {missing}"


@pytest.mark.parametrize("rel", MODULES)
def test_public_names_ported(rel):
    names = public_names(JAX_ROOT / rel)
    exceptions = EXCEPTIONS.get(rel, {})
    assert set(exceptions) <= set(names), f"{rel}: stale exceptions"
    module = port_module(pathlib.Path(rel))
    missing = [n for n in names if n not in exceptions and not resolves(module, n)]
    assert not missing, f"{rel}: not in the port: {missing}"
    ported = [n for n in exceptions if resolves(module, n)]
    assert not ported, f"{rel}: ported now, take it off EXCEPTIONS: {ported}"


def test_exceptions_are_four():
    assert sorted(n for names in EXCEPTIONS.values() for n in names) == [
        "cast_rays_scan_flat", "env_sharding", "param_shardings", "replicated"]
