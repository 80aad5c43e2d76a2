#!/usr/bin/env python3
"""How far a corpus cell's numbers follow the parts of its traffic that
no source fixes: the speaker-turn switch rate and, for a configuration
with even-quantile lengths, the spread of recording lengths within the
published range. On the card, in one process, one seed:

    python3 benchmark/tools/traffic_sweep.py <workload> <seed> <rounds>
        <variant> [<variant> ...]

A variant is `base` (the configuration as it is), `turn_switch_p=<p>`, or
`lengths=<uniform|short|long>` (the same count of recordings and speaker
counts; lengths drawn from a fixed generator uniformly over the sizes'
range, or skewed to its short or its long end). After one warm-up pass
of the first variant, each round runs one whole `diarize_ark` pass of
every variant in turn, so drift on the host falls on all of them alike.
Prints one JSON line a pass: the variant, its audio seconds over the
pass's wall seconds (`diarize_xrt` of that pass), the stage spans, the
VB buckets' padded speaker counts (the AHC cluster counts rounded up, as
the engine buckets them) weighted by recordings, and the final speaker
counts. The benchmark's own runs do not run this.
"""

import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from benchmark import harness  # noqa: E402


def variant_spec(spec: dict, variant: str) -> dict:
    """The recordings spec of `variant` (see the module docstring)."""
    import numpy as np

    out = dict(spec)
    if variant == "base":
        return out
    key, _, val = variant.partition("=")
    if key == "turn_switch_p":
        out["turn_switch_p"] = float(val)
        return out
    if key != "lengths":
        raise ValueError(f"unknown variant {variant!r}")
    ts = np.array([t for t, _ in spec["sizes"]])
    lo, hi = int(ts.min()), int(ts.max())
    u = np.random.default_rng(0x1E9).random(len(ts))
    frac = {"uniform": u, "short": u ** 2, "long": 1.0 - u ** 2}[val]
    lengths = np.rint(lo + (hi - lo) * frac).astype(int)
    out["sizes"] = [[int(t), int(k)] for t, (_, k) in
                    zip(lengths, spec["sizes"])]
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    workload, seed, rounds, variants = (argv[0], int(argv[1]),
                                        int(argv[2]), argv[3:])
    cell = harness.Cell(harness.load_manifest(), workload, seed, 0, False)
    harness.apply_host_env(cell)        # before numpy is loaded

    import torch

    from benchmark import datagen

    from vbx_tpu_torch.config import config_from_dict
    from vbx_tpu_torch.engine.pipeline import diarize_ark

    device = "cuda" if torch.cuda.is_available() else "cpu"
    cfg = config_from_dict(cell.config["diarization"])
    work = tempfile.mkdtemp(prefix="bench_sweep_")
    try:
        _, (plda_p, tr_p) = datagen.write_models(work, seed, cfg.lda_dim)
        corpora = {}
        for v in variants:
            spec = variant_spec(cell.config["recordings"], v)
            recs = datagen.recordings(spec, seed, spec["prefix"])
            d = os.path.join(work, f"v{len(corpora)}")
            os.makedirs(d)
            ark, seg = datagen.write_corpus(d, recs)
            corpora[v] = (d, ark, seg, sum(r.audio_s for r in recs))

        def one_pass(v, label):
            d, ark, seg, audio_s = corpora[v]
            log = os.path.join(d, "log.jsonl")
            t = time.perf_counter()
            outs = diarize_ark(ark, seg, os.path.join(d, "rttm"), cfg,
                               plda_p, tr_p, batch=True, verbose=False,
                               runlog_path=log, device=device)
            if device == "cuda":
                torch.cuda.synchronize()
            dt = time.perf_counter() - t
            with open(log) as f:
                st = [e for e in map(json.loads, f)
                      if e.get("event") == "stages"][-1]
            os.remove(log)
            shutil.rmtree(os.path.join(d, "rttm"))
            s_pad = {}
            for b in st.get("buckets", []):
                s_pad[b["S_pad"]] = s_pad.get(b["S_pad"], 0) + b["B"]
            spk = sorted(o.n_speakers for o in outs.values())
            print(json.dumps({
                "variant": v, "round": label, "xrt": audio_s / dt,
                "wall_s": dt, "audio_s": audio_s,
                "pre_linkage_s": st.get("pre_linkage_s"),
                "init_s": st.get("init_s"), "vb_s": st.get("vb_s"),
                "s_pad_recordings": dict(sorted(s_pad.items())),
                "n_speakers_min_median_max": [spk[0], spk[len(spk) // 2],
                                              spk[-1]]}), flush=True)

        one_pass(variants[0], "warm-up")
        for r in range(rounds):
            for v in variants:
                one_pass(v, r)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
