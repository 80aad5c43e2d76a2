"""Corpus recipe runner of the PyTorch/CUDA port: the counterpart of
recipes/run_corpus.py (the reference's per-dataset bash pipelines,
AMI_run.sh / CALLHOME_run.sh / DIHARD2_run.sh), with its stages, flags and
re-entry rules, plus --device (default cuda; 'cpu' runs on the host).

  - stage 'xvectors':    extracts every listed recording through the
                         port's extractor (engine.extractor),
  - stage 'diarization': runs the recordings through the padded-batched
                         VB engine (bucketed by length), then writes and
                         concatenates RTTMs,
  - stage 'score':       scores the preset's protocols of record
                         (AMI_run.sh:63-65 forgiving/fair/full;
                         DIHARD2_run.sh:61-62 fair/full).

Idempotent re-entry like the reference (AMI_run.sh:51): stages skip work
whose outputs already exist unless --force.

Multi-host: launch one process per host with COORDINATOR_ADDRESS
(host:port of process 0), NUM_PROCESSES and PROCESS_ID set
(parallel.distributed); the recordings shard over the processes, each
writes its share to the shared --exp-dir, and process 0 concatenates after
a barrier. Run it as `python -m vbx_tpu_torch.cli.run_corpus STAGE ...`.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

from vbx_tpu_torch.config import get_preset
from vbx_tpu_torch.metrics.der import score_corpus
from vbx_tpu_torch.utils.profiling import trace

PROTOCOLS = {          # AMI_run.sh:63-65
    "forgiving": dict(collar=0.25, ignore_overlaps=True),
    "fair": dict(collar=0.25, ignore_overlaps=False),
    "full": dict(collar=0.0, ignore_overlaps=False),
}


def build_parser():
    p = argparse.ArgumentParser(prog="python -m vbx_tpu_torch.cli.run_corpus")
    p.add_argument("stage", choices=["xvectors", "diarization", "score"],
                   help="pipeline stage (reference INSTRUCTION arg)")
    p.add_argument("--preset", required=True,
                   help="dataset preset (vbx_tpu_torch.config."
                        "DATASET_PRESETS) or a .yaml/.yml/.json config file")
    p.add_argument("--list-file", required=True,
                   help="text file with one recording name per line")
    p.add_argument("--exp-dir", required=True)
    p.add_argument("--wav-dir")
    p.add_argument("--lab-dir")
    p.add_argument("--weights", help="torch checkpoint for extraction")
    p.add_argument("--plda-file")
    p.add_argument("--xvec-transform")
    p.add_argument("--ref-rttm-dir", help="reference RTTMs for scoring")
    p.add_argument("--force", action="store_true")
    p.add_argument("--fb-impl", default=None,
                   choices=["structured", "assoc", "pallas", "pallas_bf16"],
                   help="forward-backward engine for the diarization stage")
    p.add_argument("--mesh", default=None, metavar="DPxSP",
                   help="shard the diarization stage over a ('dp','sp') "
                        "device mesh, e.g. 4x2: recordings data-parallel, "
                        "frames sequence-parallel (the long-recording "
                        "path). Built on --device. Overrides --fb-impl.")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the port on "
                        "the host)")
    return p


def _names(path):
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def stage_xvectors(args):
    from vbx_tpu_torch.engine.extractor import XVectorExtractor, extract_to_ark
    from vbx_tpu_torch.models import resnet
    from vbx_tpu_torch.parallel import distributed

    distributed.initialize()     # multi-host: no-op unless configured
    cfg = get_preset(args.preset)
    ark = os.path.join(args.exp_dir, "xvectors.ark")
    seg = os.path.join(args.exp_dir, "xvectors.seg")
    # require BOTH stage outputs: extract_to_ark writes the ark before the
    # segments file, so a kill between the two must not look complete
    if os.path.exists(ark) and os.path.exists(seg) and not args.force:
        print(f"skip: {ark} exists", file=sys.stderr)
        return
    model = resnet.load_torch_checkpoint(args.weights)
    ex = XVectorExtractor(model, cfg.sample_rate, config=cfg.extractor,
                          device=args.device)
    names = _names(args.list_file)
    os.makedirs(args.exp_dir, exist_ok=True)
    n_proc = distributed.process_count()
    if n_proc > 1:
        # recordings shard over the processes like the diarization stage;
        # each writes its own ark/seg shard, then process 0 concatenates
        # after the barrier (ark and segments are plain record streams, so
        # concatenation is exact)
        rank = distributed.process_index()
        names = names[distributed.local_recording_slice(len(names))]
        ark_out, seg_out = f"{ark}.{rank}", f"{seg}.{rank}"
    else:
        ark_out, seg_out = ark, seg
    wavs = [os.path.join(args.wav_dir, f"{n}.wav") for n in names]
    labs = [os.path.join(args.lab_dir, f"{n}.lab") for n in names]
    extract_to_ark(wavs, labs, names, ark_out, seg_out, ex)
    if n_proc == 1:
        return
    distributed.barrier("xvector_shards_written")
    if distributed.process_index() != 0:
        return
    for path in (ark, seg):
        with open(path, "wb") as out:
            for p in range(n_proc):
                shard = f"{path}.{p}"
                if not os.path.exists(shard):
                    # every process wrote its shard before the barrier; a
                    # missing one means non-shared storage or a writer
                    # failure, and skipping it would give an ark quietly
                    # missing that process's recordings
                    raise RuntimeError(
                        f"missing x-vector shard {shard}: stage output is "
                        f"on non-shared storage or process {p} failed to "
                        f"write")
                with open(shard, "rb") as f:
                    shutil.copyfileobj(f, out)   # a shard can be GBs
    for path in (ark, seg):
        for p in range(n_proc):
            os.remove(f"{path}.{p}")


def stage_diarization(args):
    from vbx_tpu_torch.engine.pipeline import diarize_ark
    from vbx_tpu_torch.parallel import distributed
    from vbx_tpu_torch.parallel.mesh import parse_mesh_arg

    distributed.initialize()     # multi-host: no-op unless configured
    cfg = get_preset(args.preset)
    rttm_dir = os.path.join(args.exp_dir, "rttms")
    out_all = os.path.join(args.exp_dir, "all.rttm")
    if os.path.exists(out_all) and not args.force:
        print(f"skip: {out_all} exists", file=sys.stderr)
        return
    diarize_ark(os.path.join(args.exp_dir, "xvectors.ark"),
                os.path.join(args.exp_dir, "xvectors.seg"),
                rttm_dir, cfg, args.plda_file, args.xvec_transform,
                resume=True, shard_over_hosts=True, fb_impl=args.fb_impl,
                mesh=parse_mesh_arg(args.mesh, device=args.device),
                device=args.device,
                runlog_path=os.path.join(args.exp_dir, "diarization.jsonl"))
    # every process must have written its RTTM slice before process 0
    # concatenates, or all.rttm silently drops recordings
    distributed.barrier("diarization_rttms_written")
    if distributed.process_index() != 0:
        return
    names = _names(args.list_file)
    with open(out_all, "w") as out:
        for n in names:
            path = os.path.join(rttm_dir, f"{n}.rttm")
            if os.path.exists(path):
                with open(path) as f:
                    out.write(f.read())


def stage_score(args):
    from vbx_tpu_torch.cli.score import _load_turns

    cfg = get_preset(args.preset)
    names = set(_names(args.list_file))
    ref = {k: v for k, v in _load_turns(
        [os.path.join(args.ref_rttm_dir, "*.rttm")]).items() if k in names}
    # filter the system side to the list too: a stale all.rttm from a run
    # over a larger list would otherwise score its extra recordings against
    # an empty reference (pure false alarm) and inflate DER
    sys_ = {k: v for k, v in _load_turns(
        [os.path.join(args.exp_dir, "all.rttm")]).items() if k in names}
    for rec in set(ref) - set(sys_):
        sys_[rec] = []
    for proto in cfg.protocols:        # protocols of record per dataset
        _, total = score_corpus(ref, sys_, **PROTOCOLS[proto])
        print(f"{proto}: DER {total.der:.2f}  JER {total.jer:.2f}  "
              f"(miss {total.missed:.1f}s fa {total.falarm:.1f}s "
              f"conf {total.confusion:.1f}s / {total.scored_time:.1f}s)")


REQUIRED_BY_STAGE = {
    "xvectors": ("wav_dir", "lab_dir", "weights"),
    "diarization": ("plda_file", "xvec_transform"),
    "score": ("ref_rttm_dir",),
}


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    missing = [f"--{opt.replace('_', '-')}"
               for opt in REQUIRED_BY_STAGE[args.stage]
               if getattr(args, opt) is None]
    if missing:
        parser.error(f"stage '{args.stage}' requires {' '.join(missing)}")
    with trace():   # torch.profiler capture iff VBX_TPU_TRACE_DIR is set
        {"xvectors": stage_xvectors,
         "diarization": stage_diarization,
         "score": stage_score}[args.stage](args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
