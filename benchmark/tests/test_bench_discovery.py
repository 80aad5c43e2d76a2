"""A configuration, a traffic mix, a cell and a per-layer metric added as
new files and manifest entries alone are found and run: no file of the
harness changes."""

import json
import os
import shutil

from bench_tiny import edit, make_root, run_cell


def test_cell_added_as_files_alone_runs(tmp_path):
    root = make_root(tmp_path)
    b = os.path.join(root, "benchmark")
    before = {f: open(os.path.join(b, f), "rb").read()
              for f in ("run.py", "harness.py", "yardstick.py",
                        "drivers/corpus.py")}
    # a new configuration, mix, comparison and reader, each its own file
    shutil.copy(f"{b}/configs/callhome.json", f"{b}/configs/tinycall.json")
    edit(f"{b}/configs/tinycall.json", lambda c: c.update(name="tinycall"))
    edit(f"{b}/configs/tinycall.json",
         lambda c: c["recordings"].update(sizes=[[520, 2], [610, 3]],
                                          turn_switch_p=0.05))
    with open(f"{b}/traffic/passes.json", "w") as f:
        json.dump({"driver": "corpus", "what": "corpus passes"}, f)
    shutil.copy(f"{b}/checks/callhome.corpus.json",
                f"{b}/checks/tinycall.passes.json")
    with open(f"{b}/metrics/passes_in_window.py", "w") as f:
        f.write("def read(ctx):\n    return float(len(ctx['stages']))\n")

    def manifest(m):
        m["configs"].append({"name": "tinycall", "source": "https://x.org",
                             "file": "benchmark/configs/tinycall.json",
                             "reduced": ["recordings.count"], "why": "t"})
        m["workloads"].append({"name": "tinycall.passes",
                               "config": "tinycall", "traffic": "passes",
                               "chips": 1, "why": "t"})
        for e in m["end_to_end"]:
            if e["name"] == "diarize_xrt":
                e["workloads"].append("tinycall.passes")
        m["per_layer"].append({"name": "passes_in_window", "unit": "n",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "corpus entry",
                               "moves": "diarize_xrt",
                               "workloads": ["tinycall.passes"]})

    edit(os.path.join(root, "BENCHMARK.json"), manifest)
    rc, res, err = run_cell(root, "tinycall.passes", trace=0)
    assert rc == 0, err[-3000:]
    assert res["correct"] and res["metrics"]["diarize_xrt"]["value"] > 0
    assert set(res["metrics"]) == {"diarize_xrt", "setup_s"}
    rc, res, err = run_cell(root, "tinycall.passes", trace=1)
    assert rc == 0, err[-3000:]
    assert res["correct"]
    assert res["metrics"]["passes_in_window"]["value"] >= 1
    # the readers whose `workloads` do not list the new cell stay silent
    assert set(res["metrics"]) == {"passes_in_window"}
    assert list(res)[-1] == "checks"
    for f, data in before.items():
        assert open(os.path.join(b, f), "rb").read() == data
