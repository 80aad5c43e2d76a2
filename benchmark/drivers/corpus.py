"""Corpus traffic: whole `diarize_ark(batch=True)` passes over an ark of
the configuration's recordings, back to back until the window has lasted
`--seconds`; the pass in flight at that moment finishes inside the
window.

End to end: `diarize_xrt`, the audio seconds the x-vectors of the
diarized recordings span over the wall seconds of the passes. Judged
afterwards, on whole passes or a sample of (pass, recording) drawn from
the seed: the RTTM the pass wrote and the ELBO trace it returned,
against the plain float64 VBx of benchmark/reference/vbx.py on the same
x-vectors and models (what is judged, and the limits, in
benchmark/checks/<workload>.json).
"""

import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from benchmark import datagen, harness, kaldi_io
from benchmark.reference import vbx as ref

DEVICE = "cuda"


def reference_settings(cfg) -> dict:
    """The settings the reference takes, from the program's config object
    built from the configuration file."""
    return {"threshold_bias": cfg.ahc.threshold,
            "init_smoothing": cfg.ahc.init_smoothing,
            "loop_prob": cfg.vb.loop_prob, "Fa": cfg.vb.Fa, "Fb": cfg.vb.Fb,
            "max_iters": cfg.vb.max_iters, "lda_dim": cfg.lda_dim}


def agreement_miss(ref_labels: np.ndarray, hyp: np.ndarray) -> float:
    """1 - the share of frames on which `hyp` names the reference's
    speaker, under the best one-to-one renaming."""
    from scipy.optimize import linear_sum_assignment

    r = np.asarray(ref_labels)
    h = np.asarray(hyp)
    nr, nh = r.max() + 1, max(h.max() + 1, 1)
    conf = np.zeros((nr, nh))
    ok = h >= 0
    np.add.at(conf, (r[ok], h[ok]), 1)
    rows, cols = linear_sum_assignment(-conf)
    return 1.0 - conf[rows, cols].sum() / len(r)


def elbo_gaps(prog: np.ndarray, refe: np.ndarray) -> tuple:
    """(relative gap at the first iteration, at the program's last): the
    gap between the program's ELBO and the reference's over the
    reference's magnitude. A trace with no finite entry reads inf."""
    prog = np.asarray(prog, np.float64)
    n = int(np.sum(np.isfinite(prog)))
    if n == 0:
        return float("inf"), float("inf")
    first = abs(prog[0] - refe[0]) / abs(refe[0])
    last = abs(prog[n - 1] - refe[n - 1]) / abs(refe[n - 1])
    return float(first), float(last)


def judged(cell, n_passes: int, names: list) -> list:
    """The (pass, recording) pairs the comparison judges: every recording
    of `whole_passes` passes drawn from the seed where the cell's checks
    file names them, else `sample` pairs drawn from the seed."""
    check = cell.check
    if "whole_passes" in check:
        return [(i, n) for i in harness.sample(
            cell.seed, list(range(n_passes)), check["whole_passes"])
                for n in names]
    return harness.sample(cell.seed, [(i, n) for i in range(n_passes)
                                      for n in names], check["sample"])


def run(cell, clock, device: str = DEVICE):
    import torch

    from vbx_tpu_torch.config import config_from_dict
    from vbx_tpu_torch.engine.pipeline import diarize_ark
    from vbx_tpu_torch.ops import fb_kernel

    on_card = device == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    cfg = config_from_dict(cell.config["diarization"])
    spec = cell.config["recordings"]
    work = tempfile.mkdtemp(prefix="bench_corpus_")
    try:
        recs = datagen.recordings(spec, cell.seed, spec["prefix"])
        (plda, transform), (plda_p, tr_p) = datagen.write_models(
            work, cell.seed, cfg.lda_dim)
        ark, seg = datagen.write_corpus(work, recs)
        by_name = {r.name: r for r in recs}

        def one_pass(i: int):
            out_dir = os.path.join(work, f"rttm{i}")
            log = os.path.join(work, f"log{i}.jsonl")
            failures = {}
            t, cpu = time.perf_counter(), time.process_time()
            outs = diarize_ark(ark, seg, out_dir, cfg, plda_p, tr_p,
                               batch=True, verbose=False, runlog_path=log,
                               failures=failures, device=device)
            sync()
            dt = time.perf_counter() - t
            cpu = time.process_time() - cpu
            with open(log) as f:
                stages = [e for e in map(json.loads, f)
                          if e.get("event") == "stages"]
            return outs, failures, dt, cpu, (stages[0] if stages else {})

        one_pass(-1)                                   # warm-up pass
        shutil.rmtree(os.path.join(work, "rttm-1"))
        setup_s = clock()

        passes = []
        fb_kernel.fb_fused_sb.launches = 0
        harness.reset_peak(on_card)
        with harness.Traced(cell.trace, work) as tr:
            with tr.mark("bench::window"):
                t0 = time.perf_counter()
                while True:
                    outs, failures, dt, cpu, stages = one_pass(len(passes))
                    passes.append({
                        "elbo": {k: o.elbo for k, o in outs.items()},
                        "failed": sorted(failures), "stages": stages,
                        "audio_s": sum(by_name[k].audio_s for k in outs)})
                    del outs
                    spans = {k: stages.get(k) for k in
                             ("pre_linkage_s", "init_s", "vb_s")}
                    # the process's CPU seconds beside the wall seconds:
                    # work that varies moves both, a host that is shared
                    # or stalls moves the wall alone
                    print(f"pass {len(passes) - 1} wall_s {dt!r} "
                          f"cpu_s {cpu!r} {spans}", file=sys.stderr)
                    if time.perf_counter() - t0 >= cell.seconds:
                        break
                window_s = time.perf_counter() - t0
        k1_launches = fb_kernel.fb_fused_sb.launches
        device_rec = harness.device_info(on_card)
        if on_card:
            torch.cuda.empty_cache()

        attempted = len(passes) * len(recs)
        failed = sum(len(p["failed"]) for p in passes)
        result = {"correct": False, "attempted": attempted,
                  "failed": failed, "device": device_rec}
        if cell.trace:
            ctx = {"window_s": window_s,
                   "stages": [p["stages"] for p in passes],
                   "k1_launches": k1_launches, "lda_dim": cfg.lda_dim,
                   "k1_esize": 2 if (cfg.vb.fb_impl == "pallas_bf16") else 4,
                   "trace": tr}
            result["metrics"] = harness.read_layer_metrics(cell, ctx)
            harness.add_trace(result, tr, window_s)
        else:
            result["metrics"] = {
                "diarize_xrt": {"value": sum(p["audio_s"] for p in passes)
                                / window_s, "unit": "audio_s/s"},
                "setup_s": {"value": setup_s, "unit": "s"}}

        # -- judged once the window has closed ------------------------------
        chosen = judged(cell, len(passes), [r.name for r in recs])
        names = sorted({n for _, n in chosen})
        refs = dict(zip(names, ref.diarize(
            [by_name[n].x for n in names], plda, transform,
            reference_settings(cfg), device=device)))
        first = last = miss = 0.0
        lost = 0
        for i, n in chosen:
            rttm = os.path.join(work, f"rttm{i}", f"{n}.rttm")
            if n in passes[i]["failed"] or not os.path.exists(rttm):
                lost += 1
                continue
            _, ref_labels, ref_elbo = refs[n]
            centers = by_name[n].times.mean(1)
            hyp = kaldi_io.read_rttm_labels(rttm, centers)
            miss = max(miss, float(agreement_miss(ref_labels, hyp)))
            f, la = elbo_gaps(passes[i]["elbo"][n], ref_elbo)
            first, last = max(first, f), max(last, la)
        # every number is printed; those the cell's comparison gives a
        # limit are held to it (benchmark/checks/<workload>.json says why
        # a number is left out)
        read = {"elbo_first_gap": first, "elbo_last_gap": last,
                "label_miss": miss}
        lim = cell.check["limits"]
        for name in sorted(set(read) - set(lim)):
            print(f"reading {name} {read[name]!r} (not compared)",
                  file=sys.stderr)
        checks = [(n, read[n], lim[n]) for n in read if n in lim]
        checks.append(("answers_lost", float(lost), 0.0))
        result["correct"] = bool(failed == 0 and harness.within(checks))
        return result, checks
    finally:
        shutil.rmtree(work, ignore_errors=True)
