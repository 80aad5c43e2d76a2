"""Nothing under benchmark/ imports a JAX package or vbx_tpu, compared by
whole top-level name (vbx_tpu_torch is the program, not vbx_tpu), no
extraction model's spec module loads one when it builds the program's
extractor and its reference, and the plain reference imports nothing of
the program."""

import ast
import os
import subprocess
import sys

import pytest

import bench_tiny
from benchmark import harness

MH = bench_tiny.with_held_out(harness.load_manifest())

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


@pytest.mark.parametrize("workload", [
    w["name"] for w in MH["workloads"]
    if harness.Cell(MH, w["name"], 1, 0, False).traffic["driver"]
    == "extract"])
def test_spec_module_loads_no_jax_or_vbx_tpu(workload):
    """In a fresh process: the cell's spec module builds the program's
    extractor and the reference embeds one window, on the CPU; then no
    forbidden module is loaded."""
    code = f"""
import sys
sys.path[:0] = [{bench_tiny.REPO!r}, {os.path.join(BENCH, "tests")!r}]
import numpy as np
import bench_tiny
from benchmark import harness
from benchmark.drivers import extract
cell = harness.Cell(bench_tiny.with_held_out(harness.load_manifest()),
                    {workload!r}, 2 ** 31 + 3, 0, False)
spec = extract.model_spec(cell)
ext, state = spec.build(cell, "cpu")
pcm = np.random.default_rng(0).standard_normal(32000) * 1000.0
emb = spec.reference(cell, state, "cpu")([(pcm, np.array([0, 32000]), 0,
                                           144)])
assert emb.shape[0] == 1 and np.isfinite(emb).all()
print(harness.forbidden_modules())
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "[]", p.stdout


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
