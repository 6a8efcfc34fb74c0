"""What the benchmark imports: no module under `gpubench/` imports JAX or
the JAX package (top-level names compared whole: the program's name
begins with the JAX package's), and the plain reference imports nothing of
the program."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

from gpubench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "kmeans_tpu"}
SOURCES = sorted(harness.HERE.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(harness.ROOT)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_name_compared_whole(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import kmeans_tpu_torch\nfrom kmeans_tpu_torch.api import x\n")
    assert top_level_imports(src) == {"kmeans_tpu_torch"}
    src.write_text("from kmeans_tpu import api\nimport jax.numpy as jnp\n")
    assert top_level_imports(src) == {"kmeans_tpu", "jax"}


@pytest.mark.parametrize("path", sorted((harness.HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "kmeans_tpu_torch" not in top_level_imports(path)
    assert top_level_imports(path) <= {"__future__", "numpy", "torch", "gpubench"}


def test_run_names_forbidden_modules():
    from gpubench import run

    assert run.forbidden_modules(["torch", "kmeans_tpu_torch.api", "gpubench.run"]) == []
    assert run.forbidden_modules(["jax.numpy", "kmeans_tpu.api", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "kmeans_tpu"]
