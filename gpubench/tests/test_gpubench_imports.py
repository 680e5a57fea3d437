"""No module of the benchmark imports JAX, the JAX package (``repro``) or
the old benchmark folder (``benchmarks``): each import's top-level name is
compared whole, so ``repro_torch`` passes."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
MODULES = sorted(p for p in HERE.rglob("*.py"))


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                in ("import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_forbidden_import(path):
    found = set(top_level_imports(path)) & FORBIDDEN
    assert not found, f"{path} imports {sorted(found)}"


def test_the_check_compares_names_whole(tmp_path):
    ok = tmp_path / "ok.py"
    ok.write_text("import repro_torch.models\nfrom repro_torch import x\n")
    bad = tmp_path / "bad.py"
    bad.write_text("from repro.models import model\n")
    assert set(top_level_imports(ok)) & FORBIDDEN == set()
    assert set(top_level_imports(bad)) & FORBIDDEN == {"repro"}
