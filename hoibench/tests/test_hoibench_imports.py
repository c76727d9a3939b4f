"""What the benchmark imports, by top-level module name compared whole:
nothing of JAX or of the JAX package anywhere, and nothing of the program
in the reference (whose name begins with the JAX package's)."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

from hoibench import harness

SOURCES = sorted(harness.PACKAGE.rglob("*.py"))


def imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            roots.add(node.args[0].value.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(harness.PACKAGE)))
def test_no_jax_anywhere(path):
    assert not imported_roots(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((harness.PACKAGE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    roots = imported_roots(path)
    assert "skghoi_torch" not in roots
    assert roots <= {"__future__", "math", "typing", "numpy", "torch", "hoibench"}


def test_the_check_compares_whole_names():
    assert imported_roots(harness.PACKAGE / "drivers" / "common.py") >= {"skghoi_torch"}
    assert "skghoi_torch" not in harness.FORBIDDEN and "skghoi_tpu" in harness.FORBIDDEN


def test_the_yardstick_beside_the_reference_imports_nothing_of_the_program():
    for name in ("roofline.py", "trace.py", "traffic.py", "weights.py", "checks.py"):
        assert "skghoi_torch" not in imported_roots(harness.PACKAGE / name)
