"""Nothing of the harness imports the JAX package or JAX, and the reference
imports nothing of the port: each import's top-level name compared whole."""
import ast
import sys
from pathlib import Path

import pytest

from perfbench import run

HARNESS = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "spfft_tpu"}
SOURCES = sorted(HARNESS.rglob("*.py"))


def top_level_imports(source: str) -> set:
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(HARNESS)) for p in SOURCES])
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path.read_text()) & FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    names = top_level_imports((HARNESS / "reference.py").read_text())
    assert "spfft_tpu_torch" not in names
    assert names <= {"__future__", "math", "torch"}


def test_the_scan_compares_whole_names():
    source = "import spfft_tpu_torch.ops\nfrom spfft_tpu_torch import x\n"
    assert top_level_imports(source) == {"spfft_tpu_torch"}
    assert not top_level_imports(source) & FORBIDDEN
    assert top_level_imports("import spfft_tpu.ops\n") & FORBIDDEN == {"spfft_tpu"}


def test_the_runs_module_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "spfft_tpu_torch_probe", object())
    assert "spfft_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.probe", object())
    assert "jaxlib" in run.forbidden_modules()
