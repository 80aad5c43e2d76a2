"""A configuration, a traffic mix, a driver, an extraction model, a cell
and a per-layer metric added as new files and manifest entries alone are
found and run: every file the root had before keeps its bytes, and the
manifest's entries only gain the new cell."""

import json
import os
import shutil

from bench_tiny import edit, make_root, run_cell


def snapshot(root):
    """Every file under the root, by path, with its bytes."""
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[path] = fh.read()
    return out


def assert_only_added(root, before):
    """Each file of `before` keeps its bytes, BENCHMARK.json aside, whose
    entries of `before` stay, their `workloads` lists only appended to."""
    manifest = os.path.join(root, "BENCHMARK.json")
    for path, data in before.items():
        if path != manifest:
            with open(path, "rb") as f:
                assert f.read() == data, path
    old, new = json.loads(before[manifest]), json.load(open(manifest))
    assert {k: v for k, v in new.items() if not isinstance(v, list)} == {
        k: v for k, v in old.items() if not isinstance(v, list)}
    for key, entries in old.items():
        if isinstance(entries, list) and key not in ("command", "paths"):
            for e, n in zip(entries, new[key]):
                w = e.get("workloads")
                assert n == dict(e, **({} if w is None else {
                    "workloads": w + n["workloads"][len(w):]}))
        elif isinstance(entries, list):
            assert new[key] == entries


def test_cell_added_as_files_alone_runs(tmp_path):
    root = make_root(tmp_path)
    b = os.path.join(root, "benchmark")
    before = snapshot(root)
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
    assert_only_added(root, before)


# A second extraction model as a later PR would bring it: a Bottleneck
# ResNet of (3, 4, 6, 3) blocks, which the program (ResNetXVector) and
# benchmark/reference/xvector.py (ResNet101's `blocks`) both build.
RESNET50_SPEC = '''"""Bottleneck ResNet (3, 4, 6, 3) over fbank + CMVN."""

from benchmark import datagen
from benchmark.drivers.extract import ref_settings
from benchmark.reference import xvector as ref


def _plain(cell):
    w = cell.config["widths"]
    return ref.ResNet101(w["feat_dim"], w["embed_dim"],
                         w["resnet_m_channels"], w["resnet_blocks"])


def build(cell, device):
    from vbx_tpu_torch.config import ExtractorConfig
    from vbx_tpu_torch.engine.extractor import XVectorExtractor
    from vbx_tpu_torch.models.resnet import Bottleneck, ResNetXVector

    w = cell.config["widths"]
    state = datagen.resnet_state(cell.seed, _plain(cell), device)
    model = ResNetXVector(Bottleneck, w["resnet_blocks"],
                          w["resnet_m_channels"], w["feat_dim"],
                          w["embed_dim"])
    model.load_state_dict(state)
    ext = XVectorExtractor(model, cell.config["diarization"]["sample_rate"],
                           ExtractorConfig(
                               **cell.config["diarization"]["extractor"]),
                           batch_size=cell.traffic["batch_size"],
                           device=device)
    return ext, state


def reference(cell, state, device, tf32=False):
    from vbx_tpu_torch.config import config_from_dict

    cfg = config_from_dict(cell.config["diarization"])
    rs = ref_settings(cfg, cfg.sample_rate)
    model = _plain(cell)
    model.load_state_dict(state)
    model.to(device)

    def embed(items):
        feats = [ref.segment_features(pcm, lab, rs)[start:start + n]
                 for pcm, lab, start, n in items]
        return ref.embed(model, feats, device, tf32=tf32)

    return embed
'''

# torch on four CPU threads, as the identity test runs it: more threads than
# that slow these small convolutions down
THREADS = "import torch; torch.set_num_threads(4)"

RESNET50_MFU = '''from benchmark import yardstick


def read(ctx):
    frames = ctx.get("windows")
    if not frames:
        return None
    w = ctx["widths"]
    flops = sum(yardstick.resnet_flops(f, w["feat_dim"],
                                       w["resnet_m_channels"],
                                       w["resnet_blocks"], w["embed_dim"])
                for f in frames)
    return 100.0 * flops / (ctx["window_s"] * yardstick.F32_OPS_PER_S)
'''


def test_extraction_model_added_as_files_alone_runs(tmp_path):
    root = make_root(tmp_path)
    b = os.path.join(root, "benchmark")
    before = snapshot(root)
    with open(f"{b}/extraction_models/resnet50.py", "w") as f:
        f.write(RESNET50_SPEC)
    with open(f"{b}/metrics/resnet50_mfu.py", "w") as f:
        f.write(RESNET50_MFU)
    shutil.copy(f"{b}/configs/ami_mixheadset.json",
                f"{b}/configs/tinyres50.json")

    def config(c):
        c.update(name="tinyres50", extraction_model="resnet50")
        c["widths"]["resnet_blocks"] = [3, 4, 6, 3]

    edit(f"{b}/configs/tinyres50.json", config)
    shutil.copy(f"{b}/checks/ami_mixheadset.extract.json",
                f"{b}/checks/tinyres50.extract.json")

    def manifest(m):
        m["configs"].append({"name": "tinyres50", "source": "https://x.org",
                             "file": "benchmark/configs/tinyres50.json",
                             "reduced": [], "why": "t"})
        m["workloads"].append({"name": "tinyres50.extract",
                               "config": "tinyres50",
                               "traffic": "wav_extract", "chips": 1,
                               "why": "t"})
        for e in m["end_to_end"]:
            if e["name"] == "extract_xrt":
                e["workloads"].append("tinyres50.extract")
        m["per_layer"].append({"name": "resnet50_mfu", "unit": "%",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "extraction",
                               "moves": "extract_xrt",
                               "workloads": ["tinyres50.extract"]})

    edit(os.path.join(root, "BENCHMARK.json"), manifest)
    rc, res, err = run_cell(root, "tinyres50.extract", trace=0, seconds=0.0,
                            extra=THREADS)
    assert rc == 0, err[-3000:]
    assert res["correct"], res
    assert res["attempted"] == 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"extract_xrt", "setup_s"}
    assert res["metrics"]["extract_xrt"]["value"] > 0
    assert res["checks"]["xvector_rel_err"]["value"] > 0
    rc, res, err = run_cell(root, "tinyres50.extract", trace=1, seconds=0.0,
                            extra=THREADS)
    assert rc == 0, err[-3000:]
    assert res["correct"], res
    assert set(res["metrics"]) == {"resnet50_mfu"}
    assert 0 < res["metrics"]["resnet50_mfu"]["value"] < 100
    assert_only_added(root, before)


def test_driver_added_as_files_alone_runs(tmp_path):
    root = make_root(tmp_path)
    b = os.path.join(root, "benchmark")
    before = snapshot(root)
    with open(f"{b}/drivers/corpus_once.py", "w") as f:
        f.write('"""One corpus pass a run, whatever --seconds says."""\n\n'
                "from benchmark.drivers import corpus\n\n\n"
                "def run(cell, clock, device='cuda'):\n"
                "    cell.seconds = 0.0\n"
                "    return corpus.run(cell, clock, device=device)\n")
    with open(f"{b}/traffic/one_pass.json", "w") as f:
        json.dump({"driver": "corpus_once", "what": "one corpus pass"}, f)
    shutil.copy(f"{b}/checks/ami_mixheadset.corpus.json",
                f"{b}/checks/ami_mixheadset.one_pass.json")

    def manifest(m):
        m["workloads"].append({"name": "ami_mixheadset.one_pass",
                               "config": "ami_mixheadset",
                               "traffic": "one_pass", "chips": 1,
                               "why": "t"})
        for e in m["end_to_end"] + m["per_layer"]:
            if e["name"] in ("diarize_xrt", "entry_share"):
                e["workloads"].append("ami_mixheadset.one_pass")

    edit(os.path.join(root, "BENCHMARK.json"), manifest)
    rc, res, err = run_cell(root, "ami_mixheadset.one_pass", trace=0,
                            seconds=30.0)
    assert rc == 0, err[-3000:]
    assert res["correct"], res
    assert res["attempted"] == 2     # one pass of the tiny copy's 2 meetings
    assert set(res["metrics"]) == {"diarize_xrt", "setup_s"}
    assert_only_added(root, before)
