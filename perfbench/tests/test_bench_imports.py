"""What the benchmark may import: nothing of JAX or the JAX package
anywhere, and nothing of the port in the reference or in the builders of
the input scenes. Top-level module names
are compared whole, since the port's name begins with the JAX package's."""

import ast

import pytest

from perfbench.cells import HERE

FORBIDDEN = {"jax", "jaxlib", "flax", "realtimepathtracingresearchframework_tpu"}
PORT = "realtimepathtracingresearchframework_tpu_torch"
FILES = sorted(HERE.rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted([*(HERE / "reference").glob("*.py"),
                                         *(HERE / "scenes").glob("*.py")]),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_reference_imports_nothing_of_the_port(path):
    """Neither the reference nor the input scenes' builders."""
    assert PORT not in top_level_imports(path)


def test_only_the_driver_module_imports_the_port():
    users = {p.relative_to(HERE).as_posix() for p in FILES
             if PORT in top_level_imports(p)}
    assert users <= {"program.py", "tests/test_bench_reference.py"}, users
