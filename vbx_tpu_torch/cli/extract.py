"""x-vector extraction CLI of the PyTorch/CUDA port: wav + VAD labels ->
Kaldi ark + segments.

The flags of vbx_tpu.cli.extract (argument parity with the reference
extractor CLI, VBx/predict.py:82-100), plus --device (default cuda; 'cpu'
runs the port on the host explicitly). `--weights` takes the reference's
torch .pth/.pt checkpoints or an exported .onnx; `--model-file` (a whole
pickled torch model) takes precedence over --weights on the pytorch
backend, as in the reference (predict.py:117-119); `--gpus` is accepted
and ignored (--device picks the card). `--backend` takes the reference's
own 'pytorch' and 'onnx' (predict.py:96-97): both run the port's torch
model, 'onnx' with weights read from the .onnx graph first-party (no
onnxruntime). Run it as `python -m vbx_tpu_torch.cli.extract ...`.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import torch

from vbx_tpu_torch.config import ExtractorConfig
from vbx_tpu_torch.engine.extractor import XVectorExtractor, extract_to_ark


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m vbx_tpu_torch.cli.extract",
        description="ResNet x-vector extraction (PyTorch/CUDA port)")
    p.add_argument("--gpus", type=str, default="",
                   help="ignored (--device picks the card)")
    p.add_argument("--model", type=str, default="ResNet101",
                   choices=["ResNet101", "ResNet34"])
    p.add_argument("--weights", required=True, type=str,
                   help="torch .pth/.pt checkpoint or exported .onnx "
                        "(reference formats)")
    p.add_argument("--model-file", type=str, default=None,
                   help="a whole pickled torch model; takes precedence "
                        "over --weights on the pytorch backend")
    p.add_argument("--ndim", type=int, default=64)
    p.add_argument("--embed-dim", type=int, default=256)
    p.add_argument("--seg-len", type=int, default=144)
    p.add_argument("--seg-jump", type=int, default=24)
    p.add_argument("--in-file-list", required=True, type=str)
    p.add_argument("--in-lab-dir", required=True, type=str)
    p.add_argument("--in-wav-dir", required=True, type=str)
    p.add_argument("--out-ark-fn", required=True, type=str)
    p.add_argument("--out-seg-fn", required=True, type=str)
    p.add_argument("--backend", default="pytorch",
                   choices=["pytorch", "onnx"],
                   help="where the weights come from (predict.py:96-97): "
                        "a torch checkpoint, or an .onnx graph read "
                        "first-party; both run the port's torch model")
    p.add_argument("--sample-rate", type=int, default=16000,
                   choices=[8000, 16000])
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="convolution dtype; bfloat16 keeps BatchNorm, the "
                        "pool and the embedding in float32 (cosine "
                        "agreement with float32 > 0.999)")
    p.add_argument("--batch-size", type=int, default=128,
                   help="extraction windows per device batch")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; 'cpu' runs on the "
                        "host)")
    return p


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    args = build_parser().parse_args(argv)

    dtype = getattr(torch, args.dtype)
    if args.backend == "onnx" or args.weights.endswith(".onnx"):
        from vbx_tpu_torch.models.onnx_import import load_onnx_checkpoint
        model = load_onnx_checkpoint(args.weights, feat_dim=args.ndim,
                                     dtype=dtype)
        if model.embed_dim != args.embed_dim:
            raise SystemExit(
                f"--embed-dim {args.embed_dim} != ONNX model embedding "
                f"width {model.embed_dim}")
    else:
        from vbx_tpu_torch.models.resnet import load_torch_checkpoint
        model = load_torch_checkpoint(
            args.model_file or args.weights, feat_dim=args.ndim,
            embed_dim=args.embed_dim, dtype=dtype, arch=args.model)

    cfg = ExtractorConfig(feat_dim=args.ndim, embed_dim=args.embed_dim,
                          seg_len=args.seg_len, seg_jump=args.seg_jump)
    extractor = XVectorExtractor(model, args.sample_rate, config=cfg,
                                 batch_size=args.batch_size,
                                 device=args.device)

    with open(args.in_file_list) as f:
        names = [line.strip() for line in f if line.strip()]
    wavs = [os.path.join(args.in_wav_dir, f"{n}.wav") for n in names]
    labs = [os.path.join(args.in_lab_dir, f"{n}.lab") for n in names]
    from vbx_tpu_torch.utils.profiling import trace
    with trace():   # torch.profiler capture iff VBX_TPU_TRACE_DIR is set
        counts = extract_to_ark(wavs, labs, names, args.out_ark_fn,
                                args.out_seg_fn, extractor)
    for name, n in counts.items():
        print(f"{name}: {n} x-vectors", file=sys.stderr)
    failed = [n for n in names if n not in counts]
    if failed:
        print(f"{len(failed)} file(s) FAILED: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
