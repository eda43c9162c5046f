"""What the benchmark imports: no module under ``bench_h100`` (its tests
aside) imports JAX, flax or the JAX package, compared by whole top-level
name (the port's name begins with the JAX package's); the reference
imports nothing of the program."""

import ast

import pytest

from conftest import ROOT

from bench_h100 import harness

BENCH_DIR = ROOT / "bench_h100"
FILES = sorted(p for p in BENCH_DIR.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_nor_the_jax_package(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "motionmixerconv_tpu_torch" not in top_level_imports(path)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "motionmixerconv_tpu_torch_like",
                        types.ModuleType("motionmixerconv_tpu_torch_like"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "motionmixerconv_tpu.serving",
                        types.ModuleType("motionmixerconv_tpu.serving"))
    assert harness.forbidden_modules() == ["motionmixerconv_tpu"]
