"""What the benchmark may import: no JAX, no JAX package anywhere under
benchmark/ (compared by whole top-level module names: the program's name
begins with the JAX package's), and nothing of the program in the
reference."""

import ast
import os

import pytest

from benchmark.harness.cell import BENCH_DIR
from benchmark.run import FORBIDDEN

SOURCES = sorted(os.path.join(d, f) for d, _, fs in os.walk(BENCH_DIR) for f in fs if f.endswith(".py"))


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_nothing_imports_jax_or_the_jax_package(path):
    assert top_level_imports(path).isdisjoint(FORBIDDEN)


@pytest.mark.parametrize("path", [p for p in SOURCES if os.sep + "reference" + os.sep in p],
                         ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_the_reference_imports_nothing_of_the_program(path):
    assert "humaniflow_torch" not in top_level_imports(path)
    assert "benchmark" not in top_level_imports(path), "the reference stands on its own files"


def test_the_names_are_compared_whole():
    """The program's name begins with the JAX package's; only whole names count."""
    assert "humaniflow_torch".split(".")[0] not in FORBIDDEN
    assert top_level_imports(__file__) >= {"ast", "os", "pytest", "benchmark"}
