"""Nothing under perfbench imports JAX or the JAX package ``repro``
(top-level names compared whole: the port, ``repro_torch``, begins with
``repro``), the references import nothing of the program either, and the
run's own check of ``sys.modules`` compares whole names too."""

import ast
import sys

from conftest import ROOT

import run as bench_run

BENCH_DIR = ROOT / "perfbench"
NEVER = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_anywhere_under_perfbench():
    for path in BENCH_DIR.rglob("*.py"):
        assert not top_level_imports(path) & NEVER, path


def test_reference_imports_none_of_the_program():
    for path in (BENCH_DIR / "reference").rglob("*.py"):
        assert not top_level_imports(path) & (NEVER | {"repro_torch"}), path


def test_module_check_compares_whole_names(monkeypatch):
    monkeypatch.delitem(sys.modules, "repro", raising=False)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    import repro_torch  # noqa: F401
    assert bench_run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.models", object())
    assert bench_run.forbidden_modules() == ["repro"]
