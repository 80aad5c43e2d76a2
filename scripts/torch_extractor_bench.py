#!/usr/bin/env python3
"""x-vector extractor throughput and its precision A/B on the card (the
counterpart of scripts/extractor_bench.py for the PyTorch/CUDA port).

The extractor is the FLOPs-heavy stage of the pipeline (ResNet101 over
144-frame windows every 0.24 s of speech — reference predict.py:179-193).
This bench:

1. runs the full extractor (engine.extractor.XVectorExtractor, batch 64:
   fbank -> CMVN -> windows -> ResNet101 forward, seeded random weights at
   the reference's width and depth) on synthetic speech and reports
   windows/s and the real-time factor,
2. A/Bs models.resnet.resnet101(precision=None) against
   precision='highest': embedding agreement (cosine and max-abs after l2
   norm — the AHC chain consumes l2-normalized embeddings) and the
   throughput cost,
3. checks the downstream effect: AHC labels on the two embedding sets.

'highest' runs the model's forward with TF32 off (device.
full_fp32_matmuls); None leaves PyTorch's settings as they are. Note that
XVectorExtractor runs its whole extraction inside full_fp32_matmuls, so
on the card both rows run at full float32 there; on the CPU there is no
TF32 and the rows are identical by construction.

    python3 scripts/torch_extractor_bench.py [minutes_of_audio] [--device cpu]

Results go to stdout in extractor_bench.py's lines, then one JSON line;
details to stderr. With no card and no --device cpu it exits non-zero.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

FS = 16000


def synth_speech(minutes):
    """extractor_bench.py's signal: AR-filtered noise with energy
    modulation so fbank/CMVN see realistic dynamic range; VAD = all."""
    n = int(minutes * 60 * FS)
    rng = np.random.default_rng(0)
    sig = rng.standard_normal(n).astype(np.float32)
    sig = np.convolve(sig, [1.0, 0.7, 0.4], mode="same")
    sig *= 0.1 * (1.0 + 0.5 * np.sin(np.arange(n) * 2e-4))
    return sig, np.array([[0.0, n / FS]])


def seeded_resnet101(precision):
    """ResNet101 at the reference's width and depth, seed 0, embedding
    bias zero (chip_smoke.py's write_seeded_resnet101's weights)."""
    import torch

    from vbx_tpu_torch.models.resnet import resnet101

    torch.manual_seed(0)
    model = resnet101(64, 256, precision=precision)
    torch.nn.init.zeros_(model.embedding.bias)
    return model


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("minutes", type=float, nargs="?", default=4.0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    from vbx_tpu_torch.utils.devices import measured_on

    on = measured_on(args.device, "torch_extractor_bench")
    if on is None:
        return 2
    import torch

    from vbx_tpu_torch.config import ExtractorConfig
    from vbx_tpu_torch.engine.ahc import ahc_labels
    from vbx_tpu_torch.engine.extractor import XVectorExtractor

    sig, vad = synth_speech(args.minutes)
    print(f"device: {on}  audio={args.minutes:.1f} min", file=sys.stderr,
          flush=True)

    def sync():
        if args.device == "cuda":
            torch.cuda.synchronize()

    results, rows = {}, {}
    audio_s = args.minutes * 60
    for label, prec in (("default", None), ("highest", "highest")):
        ext = XVectorExtractor(seeded_resnet101(prec), FS,
                               config=ExtractorConfig(), batch_size=64,
                               device=args.device)
        t0 = time.perf_counter()
        segs = ext.extract_file(sig, vad, "bench")      # build + run
        sync()
        t_cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        segs = ext.extract_file(sig, vad, "bench")
        sync()
        t_warm = time.perf_counter() - t0
        emb = np.stack([s.xvector for s in segs])
        print(f"precision={label:8s}: {len(segs)} windows, "
              f"warm {t_warm:.2f}s ({len(segs) / t_warm:.0f} windows/s, "
              f"{audio_s / t_warm:.0f}x realtime; cold {t_cold:.1f}s)",
              flush=True)
        results[label] = emb
        rows[label] = {"windows": len(segs), "warm_s": t_warm,
                       "cold_s": t_cold, "windows_per_s": len(segs) / t_warm,
                       "x_realtime": audio_s / t_warm}

    a = results["default"] / np.linalg.norm(results["default"], axis=1,
                                            keepdims=True)
    b = results["highest"] / np.linalg.norm(results["highest"], axis=1,
                                            keepdims=True)
    cos = np.sum(a * b, axis=1)
    diff = float(np.abs(a - b).max())
    print(f"embedding agreement (l2-normalized): cos min/mean = "
          f"{cos.min():.6f}/{cos.mean():.6f}, max|diff| = "
          f"{diff:.2e}", flush=True)

    lab_a = ahc_labels(a.astype(np.float64), 0.0, compute_backend="host")
    lab_b = ahc_labels(b.astype(np.float64), 0.0, compute_backend="host")
    same = bool(np.array_equal(lab_a, lab_b))
    print(f"downstream AHC labels identical: {same} "
          f"(clusters {len(np.unique(lab_a))}/{len(np.unique(lab_b))})",
          flush=True)
    print(json.dumps({"driver": "extractor", "device": on,
                      "minutes": args.minutes, "rows": rows,
                      "cos_min": float(cos.min()),
                      "cos_mean": float(cos.mean()), "max_abs_diff": diff,
                      "ahc_labels_identical": same}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
