"""The port (piquant_tpu_torch) and its GPU smoke script import nothing of
JAX or of the JAX package (piquant_tpu): neither exists on the machine with
the card.  Every import statement, at any depth, and every import_module /
__import__ call with a literal name is checked; docstrings may still name
the JAX files a module is the counterpart of."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "piquant_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _banned(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "piquant_tpu")


def _imports(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            yield node.args[0].value


def test_scan_covers_the_package_and_catches_imports():
    names = {p.name for p in FILES}
    assert {"api.py", "dtypes.py", "dispatch.py", "reference.py",
            "moe.py", "ragged.py", "chip_smoke.py", "collectives.py",
            "rdma_ring.py", "mesh.py", "generate.py", "ring.py"} <= names
    probe = ast.parse("def f():\n    import jax.numpy as jnp\n"
                      "from piquant_tpu.ops import reference\n"
                      "import piquant_tpu_torch\n"
                      "importlib.import_module('piquant_tpu.api')\n")
    assert {m for m in _imports(probe) if _banned(m)} == {
        "jax.numpy", "piquant_tpu.ops", "piquant_tpu.api"}


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_nothing_of_jax(path):
    hits = [m for m in _imports(ast.parse(path.read_text())) if _banned(m)]
    assert not hits, f"{path.name} imports {hits}"
