"""Extraction traffic: `extract_to_ark` over one wav + VAD file a call,
as VBx's extract.sh runs one file at a time, cycling through the mix's
recordings in the mix's order until the window has lasted `--seconds`; the call in flight
at that moment finishes inside the window.

End to end: `extract_xrt`, the wav seconds of the files turned into ark +
segments over the wall seconds of the calls. Judged afterwards: every
call's segments file against the windows the plain reference cuts from
the same VAD (keys, start and end seconds, exact), and a sample of the
x-vectors drawn from the seed against the configuration's plain model on
the same samples and weights.

The model is the configuration's: its `extraction_model` names the spec
module benchmark/extraction_models/<name>.py (`resnet101` where it names
none), which builds the program's extractor and the plain reference
(that module's docstring gives the contract). A later extraction model is
a spec module, a configuration and their entries; no file here changes.
"""

import importlib
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from benchmark import datagen, harness, kaldi_io
from benchmark.reference import xvector as ref


def _files(cell, seed: int):
    """[(name, int16 pcm, VAD [V, 2] s)] of the mix in its own order:
    fixed lengths and VAD turns (the mix's vad_seed), content from
    `seed`, so every seed's window runs the same calls."""
    tr = cell.traffic
    fs = cell.config["diarization"]["sample_rate"]
    vrng = np.random.default_rng(tr["vad_seed"])
    srng = np.random.default_rng([seed, 0xA0D10])
    out = []
    for i, minutes in enumerate(tr["minutes"]):
        n = int(minutes * 60 * fs)
        vad = datagen.vad_turns(vrng, n / fs, tr["turn_s"], tr["pause_s"])
        pcm = np.rint(datagen.speech_signal(srng, n) * 32768.0).astype(
            np.int16)
        out.append((f"rec{i}", pcm, vad))
    return out


def model_spec(cell):
    """The module of benchmark/extraction_models/ the configuration
    names."""
    return importlib.import_module("benchmark.extraction_models."
                                   + cell.config.get("extraction_model",
                                                     "resnet101"))


def ref_settings(cfg, fs: int) -> dict:
    e = cfg.extractor
    return {"fbank": ref.fbank_config(fs), "sample_rate": fs,
            "seg_len": e.seg_len, "seg_jump": e.seg_jump,
            "min_tail_frames": e.min_tail_frames, "cmvn_lc": e.cmvn_lc,
            "cmvn_rc": e.cmvn_rc, "dither_level": e.dither_level,
            "dither_seed": e.dither_seed}


def run(cell, clock, device: str = "cuda"):
    import torch

    from vbx_tpu_torch.config import config_from_dict
    from vbx_tpu_torch.engine.extractor import extract_to_ark

    on_card = device == "cuda"
    cfg = config_from_dict(cell.config["diarization"])
    fs = cfg.sample_rate
    spec = model_spec(cell)
    work = tempfile.mkdtemp(prefix="bench_extract_")
    try:
        files = _files(cell, cell.seed)
        paths = {}
        for name, pcm, vad in files:
            wav, lab = f"{work}/{name}.wav", f"{work}/{name}.lab"
            kaldi_io.write_wav(wav, pcm, fs)
            kaldi_io.write_lab(lab, vad)
            paths[name] = (wav, lab)
        # warm-up file: the first minute of the first recording
        _, wpcm, wvad = files[0]
        cut = wvad[wvad[:, 1] <= 60.0]
        kaldi_io.write_wav(f"{work}/warm.wav", wpcm[:60 * fs], fs)
        kaldi_io.write_lab(f"{work}/warm.lab", cut)

        ext, state = spec.build(cell, device)
        extract_to_ark([f"{work}/warm.wav"], [f"{work}/warm.lab"], ["warm"],
                       f"{work}/warm.ark", f"{work}/warm.seg", ext)
        if on_card:
            torch.cuda.synchronize()
        setup_s = clock()

        calls = []
        harness.reset_peak(on_card)
        with harness.Traced(cell.trace, work) as tr:
            with tr.mark("bench::window"):
                t0 = time.perf_counter()
                while True:
                    name, pcm, _ = files[len(calls) % len(files)]
                    i = len(calls)
                    ark, seg = f"{work}/c{i}.ark", f"{work}/c{i}.seg"
                    err = None
                    t = time.perf_counter()
                    try:
                        extract_to_ark([paths[name][0]], [paths[name][1]],
                                       [name], ark, seg, ext)
                        if on_card:
                            torch.cuda.synchronize()
                    except Exception as exc:   # noqa: BLE001 — a failed
                        err = f"{type(exc).__name__}: {exc}"   # call
                    calls.append({"name": name, "ark": ark, "seg": seg,
                                  "audio_s": len(pcm) / fs, "error": err})
                    print(f"call {i} {name} audio_s {len(pcm) / fs!r} "
                          f"wall_s {time.perf_counter() - t!r}",
                          file=sys.stderr)
                    if time.perf_counter() - t0 >= cell.seconds:
                        break
                window_s = time.perf_counter() - t0
        device_rec = harness.device_info(on_card)
        del ext
        if on_card:
            torch.cuda.empty_cache()

        done = [c for c in calls if c["error"] is None]
        result = {"correct": False, "attempted": len(calls),
                  "failed": len(calls) - len(done), "device": device_rec}
        segs = {i: kaldi_io.read_segments(c["seg"])
                for i, c in enumerate(calls) if c["error"] is None}
        if cell.trace:
            ctx = {"window_s": window_s, "trace": tr,
                   "windows": [int(k.rsplit("-", 1)[1]) -
                               int(k.rsplit("-", 2)[1])
                               for rows in segs.values()
                               for k, _, _, _ in rows],
                   "widths": cell.config["widths"]}
            result["metrics"] = harness.read_layer_metrics(cell, ctx)
            harness.add_trace(result, tr, window_s)
        else:
            result["metrics"] = {
                "extract_xrt": {"value": sum(c["audio_s"] for c in done)
                                / window_s, "unit": "audio_s/s"},
                "setup_s": {"value": setup_s, "unit": "s"}}

        # -- judged once the window has closed ------------------------------
        rs = ref_settings(cfg, fs)
        by_name = {n: (pcm, vad) for n, pcm, vad in files}
        expected = {n: {r[0]: r for r in ref.windows(n, vad, len(pcm), rs)}
                    for n, (pcm, vad) in by_name.items()}
        wrong_rows = 0
        pool = []
        for i, rows in segs.items():
            name = calls[i]["name"]
            exp = {k: r[1:3] for k, r in expected[name].items()}
            got = {k: (s, e) for k, _, s, e in rows}
            wrong_rows += len(set(exp.items()) ^ set(got.items()))
            pool += [(i, k) for k in sorted(got) if k in exp]
        chosen = harness.sample(cell.seed, pool, cell.check["sample"])
        arks = {i: kaldi_io.read_vec_ark(calls[i]["ark"])
                for i in sorted({i for i, _ in chosen})}
        items, prog = [], []
        dithered = {}
        for i, k in chosen:
            name = calls[i]["name"]
            if name not in dithered:
                dithered[name] = ref.dither(by_name[name][0],
                                            rs["dither_level"],
                                            rs["dither_seed"])
            _, _, _, segnum, start, length = expected[name][k]
            lab = (by_name[name][1][segnum] * fs).astype(int)
            items.append((dithered[name], lab, start, length))
            prog.append(arks[i][k])
        emb = spec.reference(cell, state, device)(items) if items else []
        err = max((float(np.linalg.norm(p - r) / np.linalg.norm(r))
                   for p, r in zip(prog, emb)), default=0.0)
        checks = [("xvector_rel_err", err,
                   cell.check["limits"]["xvector_rel_err"]),
                  ("segment_rows_wrong", float(wrong_rows), 0.0)]
        result["correct"] = bool(result["failed"] == 0 and chosen
                                 and harness.within(checks))
        return result, checks
    finally:
        shutil.rmtree(work, ignore_errors=True)
