"""Nothing the benchmark runs imports JAX or the JAX package `repro`
(top-level module names compared whole: `repro_torch` is the program),
and the reference imports nothing of the program."""
import ast
from pathlib import Path

import pytest

from bench import cell

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_torch_alone(path):
    assert top_level_imports(path) <= {"torch", "math", "importlib",
                                       "__future__"}


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "repro_torch_fake_probe", object())
    assert "repro" not in cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.fake_probe", object())
    assert "repro" in cell.forbidden_modules()
