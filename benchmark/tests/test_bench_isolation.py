"""Nothing under benchmark/ imports a JAX package or vbx_tpu, compared by
whole top-level name (vbx_tpu_torch is the program, not vbx_tpu), and the
plain reference imports nothing of the program."""

import ast
import os
import sys

import pytest

import bench_tiny  # noqa: F401  (puts the repository on sys.path)
from benchmark import harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def py_files(d):
    return [os.path.join(p, f) for p, _, fs in os.walk(d) for f in fs
            if f.endswith(".py")]


def test_nothing_imports_jax_or_vbx_tpu():
    files = py_files(BENCH)
    assert len(files) > 10
    for path in files:
        bad = top_level_imports(path) & {"jax", "jaxlib", "flax", "vbx_tpu"}
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_program():
    files = py_files(os.path.join(BENCH, "reference"))
    assert files
    for path in files:
        names = top_level_imports(path)
        assert "vbx_tpu_torch" not in names, path
        assert "benchmark" not in names, path


@pytest.mark.parametrize("loaded,flagged", [
    ("vbx_tpu_torch.engine", []), ("vbx_tpu.engine", ["vbx_tpu"]),
    ("jaxlib.xla_client", ["jaxlib"]), ("jaxtyping", [])])
def test_forbidden_modules_compare_whole_names(monkeypatch, loaded, flagged):
    for m in [m for m in sys.modules if m.split(".")[0] in
              harness.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, loaded, object())
    assert harness.forbidden_modules() == flagged
