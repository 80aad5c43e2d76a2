"""A copy of the benchmark at sizes a CPU test holds: the manifest and
every file of benchmark/ under a temporary root, with the corpus
configurations cut to a few short recordings (the VB stop rules off, so
the CPU's structured engine runs the 40 iterations the card's bfloat16
engine runs) and the extraction mix to two short wavs, every recording
in the sample, and the cells of benchmark/held_out.json added back to
its manifest. The limits are the cells' own."""

import copy
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def edit(path, fn):
    with open(path) as f:
        d = json.load(f)
    fn(d)
    with open(path, "w") as f:
        json.dump(d, f, indent=1)


def with_held_out(manifest: dict) -> dict:
    """A copy of `manifest` with the cells of benchmark/held_out.json added
    back, as the file says to."""
    with open(os.path.join(REPO, "benchmark", "held_out.json")) as f:
        held = json.load(f)
    m = copy.deepcopy(manifest)
    m["configs"] += held["configs"]
    m["workloads"] += held["workloads"]
    for e in m["end_to_end"] + m["per_layer"]:
        if e["name"] in held["metric_workloads"]:
            e["workloads"] = e["workloads"] + held["metric_workloads"][
                e["name"]]
    return m


def make_root(tmp) -> str:
    """The tiny copy under `tmp`; returns its root."""
    root = os.path.join(str(tmp), "root")
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    edit(os.path.join(root, "BENCHMARK.json"), lambda m: m.update(
        with_held_out(m)))
    b = os.path.join(root, "benchmark")

    def corpus(sizes):
        def fn(c):
            c["recordings"]["sizes"] = sizes
            c["diarization"]["vb"]["epsilon"] = -1e30
            c["diarization"]["vb"]["plateau_ulps"] = 0.0
        return fn

    edit(f"{b}/configs/ami_mixheadset.json", corpus([[700, 3], [900, 4]]))
    edit(f"{b}/configs/callhome.json",
         corpus([[500, 2], [620, 3], [560, 2]]))
    edit(f"{b}/traffic/wav_extract.json",
         lambda t: t.update(minutes=[0.6, 0.35]))
    for w in os.listdir(f"{b}/checks"):
        edit(f"{b}/checks/{w}", lambda c: c.update(sample=1000))
    return root


def run_cell(root, workload, seed=3000000019, trace=0, seconds=1.0,
             extra=""):
    """`run.main` of the copy at `root` in a fresh process on the CPU
    (no card check), with `extra` Python run first (a fault planted in
    the program); returns (exit code, the result line or None, stderr)."""
    code = (f"import sys; sys.path.insert(0, {root!r}); "
            f"sys.path.append({REPO!r})\n{extra}\n"
            f"from benchmark import run\n"
            f"sys.exit(run.main(['--workload', {workload!r}, '--seed', "
            f"'{seed}', '--seconds', '{seconds}', '--trace', '{trace}'], "
            f"device='cpu'))\n")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=root, env=env, timeout=900)
    lines = p.stdout.strip().splitlines()
    res = json.loads(lines[-1]) if lines and lines[-1].startswith("{") \
        else None
    return p.returncode, res, p.stderr
