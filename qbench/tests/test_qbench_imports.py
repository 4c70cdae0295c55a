"""What the benchmark imports: never JAX or the JAX package; the reference nothing of the port.

Module names are compared by their top-level name, the part before the
first dot, whole: ``gpuradixsort_tpu_torch`` is the port and passes,
``gpuradixsort_tpu`` is the JAX package and fails.
"""

from __future__ import annotations

import ast
import pathlib

import pytest

from qbench import registry, run

FORBIDDEN = {"jax", "jaxlib", "flax", "gpuradixsort_tpu"}
PORT = "gpuradixsort_tpu_torch"
SOURCES = sorted(registry.HERE.rglob("*.py"))


def imported(path: pathlib.Path) -> set[str]:
    """Top-level names of every module a source imports, at any depth of its code."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


def test_top_level_names_are_compared_whole(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import gpuradixsort_tpu_torch.ops.sort\nfrom gpuradixsort_tpu.ops import x\n")
    assert imported(src) == {PORT, "gpuradixsort_tpu"}
    assert run.FORBIDDEN and set(run.FORBIDDEN) == FORBIDDEN


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(registry.HERE)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in SOURCES
                                  if p.parent.name == "reference" or p.name == "check.py"],
                         ids=lambda p: str(p.relative_to(registry.HERE)))
def test_reference_imports_nothing_of_the_port(path):
    assert PORT not in imported(path)
    assert not any(name.startswith(PORT) for name in imported(path))


def test_forbidden_modules_reads_sys_modules(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "gpuradixsort_tpu_torch_fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gpuradixsort_tpu.fake", object())
    assert run.forbidden_modules() == ["gpuradixsort_tpu.fake"]
