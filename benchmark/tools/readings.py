#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card, at the cell's
own size. For each seed:
- a corpus cell: one diarize_ark pass of the program (as the window runs
  it) and, on the cell's sample of recordings, the numbers `correct`
  compares against the float64 reference, for the program and for the
  control (the reference with its streams rounded to float8 e4m3 where
  the configuration stores bfloat16; its AHC stays float64), and the
  label miss of the altered-answer fault planted in the reference (every
  other frame's label set to 0);
- an extraction cell: a run of one call, and the control (the plain
  model of the configuration's spec module, benchmark/extraction_models/,
  with TF32 on) against the reference on a sample of the first file's
  windows.

    python3 benchmark/tools/readings.py <workload> <seed> [<seed> ...]

One JSON line a seed on stdout, then a summary line; the benchmark's own
runs do not run this.
"""

import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark import datagen, harness, kaldi_io  # noqa: E402
from benchmark.drivers import corpus  # noqa: E402
from benchmark.reference import vbx as ref  # noqa: E402


def numbers(names, refs, hyps, elbos):
    """The corpus comparison's numbers over `names`: labels `hyps` and
    ELBO traces `elbos` against the reference's `refs`."""
    first = last = miss = 0.0
    for n in names:
        _, labels, e = refs[n]
        miss = max(miss, corpus.agreement_miss(labels, hyps[n]))
        f, la = corpus.elbo_gaps(elbos[n], e)
        first, last = max(first, f), max(last, la)
    return {"elbo_first_gap": first, "elbo_last_gap": last,
            "label_miss": miss}


def extraction(cell, seed: int, device: str) -> dict:
    """One seed of an extraction cell: the program's run (a window of one
    call) and the control (the configuration's plain model with TF32 on)
    against the reference on a sample of the first file's windows."""
    import numpy as np

    from vbx_tpu_torch.config import config_from_dict

    from benchmark.drivers import extract
    from benchmark.reference import xvector as xref

    cell.seed, cell.seconds, cell.trace = seed, 1.0, False
    result, checks = extract.run(cell, harness.Clock(), device=device)
    cfg = config_from_dict(dict(cell.config["diarization"]))
    rs = extract.ref_settings(cfg, cfg.sample_rate)
    name, pcm, vad = extract._files(cell, seed)[0]
    rows = harness.sample(seed, xref.windows(name, vad, len(pcm), rs),
                          cell.check["sample"])
    sig = xref.dither(pcm, rs["dither_level"], rs["dither_seed"])
    items = [(sig, (vad[segnum] * cfg.sample_rate).astype(int), start,
              length) for _, _, _, segnum, start, length in rows]
    spec = extract.model_spec(cell)
    _, state = spec.build(cell, device)
    base = spec.reference(cell, state, device)(items)
    ctl = spec.reference(cell, state, device, tf32=True)(items)
    err = max(float(np.linalg.norm(c - b) / np.linalg.norm(b))
              for c, b in zip(ctl, base))
    return {"seed": seed, "correct": result["correct"],
            "program": {n: v for n, v, _ in checks},
            "control": {"xvector_rel_err": err}}


def main(argv=None) -> int:
    import numpy as np
    import torch

    from vbx_tpu_torch.config import config_from_dict
    from vbx_tpu_torch.engine.pipeline import diarize_ark

    argv = sys.argv[1:] if argv is None else argv
    device = "cuda" if torch.cuda.is_available() else "cpu"
    cell = harness.Cell(harness.load_manifest(), argv[0], 0, 0, False)
    if cell.traffic["driver"] == "extract":
        rows = [extraction(cell, int(s), device) for s in argv[1:]]
        for row in rows:
            print(json.dumps(row), flush=True)
        print(json.dumps({"workload": argv[0], "seeds": len(rows),
                          "min_max": {side: {k: [min(r[side][k] for r in rows),
                                                 max(r[side][k] for r in rows)]
                                             for k in rows[0][side]}
                                      for side in ("program", "control")}}))
        return 0
    cfg = config_from_dict(json.loads(json.dumps(
        cell.config["diarization"])))
    spec = cell.config["recordings"]
    rows = []
    for seed in map(int, argv[1:]):
        work = tempfile.mkdtemp(prefix="bench_readings_")
        try:
            recs = datagen.recordings(spec, seed, spec["prefix"])
            by_name = {r.name: r for r in recs}
            (plda, transform), (pp, tp) = datagen.write_models(
                work, seed, cfg.lda_dim)
            ark, seg = datagen.write_corpus(work, recs)
            outs = diarize_ark(ark, seg, f"{work}/rttm", cfg, pp, tp,
                               batch=True, verbose=False, device=device)
            cell.seed = seed
            names = [n for _, n in corpus.judged(
                cell, 1, [r.name for r in recs])]
            xs = [by_name[n].x for n in names]
            st = corpus.reference_settings(cfg)
            t = time.perf_counter()
            base = ref.diarize(xs, plda, transform, st, device=device)
            ref_s = time.perf_counter() - t
            refs = dict(zip(names, base))
            ctl = ref.diarize(xs, plda, transform, st, device=device,
                              stream=torch.float8_e4m3fn,
                              labels_init=[a for a, _, _ in base])
            hyps = {n: kaldi_io.read_rttm_labels(
                f"{work}/rttm/{n}.rttm", by_name[n].times.mean(1))
                for n in names}
            row = {"seed": seed,
                   "program": numbers(names, refs, hyps,
                                      {n: outs[n].elbo for n in names}),
                   "control": numbers(
                       names, refs, {n: c[1] for n, c in zip(names, ctl)},
                       {n: c[2] for n, c in zip(names, ctl)}),
                   "fault_label_miss": max(
                       corpus.agreement_miss(b[1], np.where(
                           np.arange(len(b[1])) % 2 == 0, 0, b[1]))
                       for b in base),
                   "iters": sorted({int(outs[n].n_iters) for n in names}),
                   "ahc_clusters": [int(a.max()) + 1 for a, _, _ in base],
                   "reference_s": ref_s}
            print(json.dumps(row), flush=True)
            rows.append(row)
        finally:
            shutil.rmtree(work, ignore_errors=True)
    summary = {side: {k: [min(r[side][k] for r in rows),
                          max(r[side][k] for r in rows)]
                      for k in rows[0][side]} for side in ("program",
                                                           "control")}
    print(json.dumps({"workload": argv[0], "seeds": len(rows),
                      "min_max": summary}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
