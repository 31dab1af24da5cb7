"""Nothing the benchmark runs loads JAX or the JAX package (top-level
names compared whole: the port, ``repro_torch``, begins with
``repro``), and the plain reference loads nothing of the program."""

import ast
from pathlib import Path

import pytest

from perfbench.lib import env

PERFBENCH = Path(__file__).resolve().parents[1]
SOURCES = sorted(PERFBENCH.rglob("*.py"))


def imported_tops(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module":
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                yield arg.value.split(".")[0]
            elif isinstance(arg, ast.JoinedStr):
                yield arg.values[0].value.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(PERFBENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not set(imported_tops(path)) & set(env.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((PERFBENCH / "reference")
                                        .rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_loads_nothing_of_the_program(path):
    tops = set(imported_tops(path))
    assert "repro_torch" not in tops
    assert tops <= {"__future__", "contextlib", "math", "typing", "torch"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "repro_torch_like",
                        types.ModuleType("repro_torch_like"))
    assert "repro" not in env.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core",
                        types.ModuleType("repro.core"))
    assert "repro" in env.forbidden_modules()
