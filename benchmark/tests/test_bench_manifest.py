"""BENCHMARK.json against its contract: keys, names and units in their
character sets, every cell's files found by name, every per-layer metric
with a reader, bounds and the run length within their limits."""

import json
import os
import re

import pytest

import bench_tiny
from benchmark import harness
from benchmark.drivers import extract

M = harness.load_manifest()
# the manifest with benchmark/held_out.json's cells added back: they are
# held to the same rules, so that adding them back is entries alone
MH = bench_tiny.with_held_out(M)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|"
                   r"_dim$|_rank$|head|expansion|experts_per|width|"
                   r"channels)")


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "benchmark/run.py"]
    assert M["paths"] == ["benchmark"]
    assert all(PATH.match(p) for p in M["paths"])
    with open(os.path.join(bench_tiny.REPO, "BENCHMARK.json"), "rb") as f:
        assert len(f.read()) <= 64 * 1024


def test_names_units_and_text_fields():
    names = ([c["name"] for c in M["configs"]]
             + [w["name"] for w in M["workloads"]]
             + [m["name"] for m in M["end_to_end"] + M["per_layer"]])
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in M["workloads"]] + [
            k for c in M["configs"] for k in c["reduced"]]:
        assert NAME.match(n), n
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    texts = ([c["why"] for c in M["configs"]] + [c["source"] for c in
                                                 M["configs"]]
             + [w["why"] for w in M["workloads"]]
             + [m["layer"] for m in M["per_layer"]] + M["command"])
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t


@pytest.mark.parametrize("M", [M, MH], ids=["manifest", "with_held_out"])
def test_configs_and_their_files(M):
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        with open(os.path.join(bench_tiny.REPO, c["file"])) as f:
            d = json.load(f)
        assert d["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"]), c
        assert any(w["config"] == c["name"] for w in M["workloads"])


@pytest.mark.parametrize("w", MH["workloads"], ids=lambda w: w["name"])
def test_every_cell_is_found_by_name(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1
    cell = harness.Cell(MH, w["name"], 1, 1.0, False)
    # the harness's own rule: the mix names a module of benchmark/drivers/
    # with `run`; an extraction cell's configuration, a spec module of
    # benchmark/extraction_models/ with `build` and `reference`
    drv = os.path.join(harness.BENCH_DIR, "drivers",
                       f"{cell.traffic['driver']}.py")
    assert os.path.isfile(drv), drv
    assert callable(harness.driver(cell).run)
    if cell.traffic["driver"] == "extract":
        spec = extract.model_spec(cell)
        assert os.path.dirname(spec.__file__) == os.path.join(
            harness.BENCH_DIR, "extraction_models")
        assert callable(spec.build) and callable(spec.reference)
    e2e = {m["name"] for m in cell.metrics("end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = cell.metrics("per_layer")
    assert layers
    for m in layers:
        assert m["moves"] in e2e


def test_pairs_are_unique_and_four_chip_cells_few():
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert 1 <= len(M["workloads"]) <= 24


@pytest.mark.parametrize("M", [M, MH], ids=["manifest", "with_held_out"])
def test_metrics_and_bounds(M):
    cells = {w["name"] for w in M["workloads"]}
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in M["end_to_end"])
    e2e = {m["name"]: m for m in M["end_to_end"]}
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)
        assert callable(harness.reader(m["name"]))
    layer_names = {m["layer"] for m in M["per_layer"]}
    assert all("\n" not in n for n in layer_names)


def test_run_seconds_fits_the_full_check_with_24_cells():
    rs = M["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_cell_has_its_comparison():
    for w in MH["workloads"]:
        cell = harness.Cell(MH, w["name"], 1, 1.0, False)
        assert (cell.check.get("sample", 0) >= 1
                or cell.check.get("whole_passes", 0) >= 1)
        assert cell.check["limits"]
        for v in cell.check["limits"].values():
            assert 0 < v < 1
