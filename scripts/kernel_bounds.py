#!/usr/bin/env python3
"""Least times on an H100 for the kernels of vbx_tpu/ops/fb_pallas.py as
ported: K1 (the fused [B, T, S] walk, vbx_tpu_torch/csrc/fb_fused_sb.cu)
at the bench shape and the solo long-recording shape, K2 (the
block-operator walk, csrc/fb_fwd_product_sb.cu) at chip_smoke.py's shapes,
and K3-K5 (the [T, B, S] layout, csrc/fb_scan_tbs.cu) at the shapes
tests/test_pallas.py gives them and at the kernel A/B tool's shape
(scripts/torch_ab_fb_kernels.py: T=1025, S=31, B=256).

    python3 scripts/kernel_bounds.py

The bound of a call is the larger of its bytes over the card's memory rate
(each input read once, each output written once, float32) and its
operations over the float32 rate outside the tensor cores. Pure
arithmetic on shapes: no card is needed, and nothing is measured.
chip_smoke.py computes the same bounds from the inputs of its own run,
beside the measured times.
"""

import json

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
# fb_scan_pallas (T, S, B) in tests/test_pallas.py, then the A/B tool's
SHAPES = ((40, 5, 3), (600, 31, 4), (1025, 31, 256))


# K3-K5 by the name of their wrappers (vbx_tpu_torch.ops.fb_scan_kernel)
SCAN_KERNELS = {"fb_scan_fused": "K3 _fused_kernel",
                "fb_scan_fwd": "K4 _fwd_kernel",
                "fb_scan_bwd": "K5 _bwd_kernel"}


def scan_bound(T: int, B: int, S: int, kernel: str) -> dict:
    """K3-K5 on float32 [T, B, S] weights: the bytes each function must
    move (w, col and pinit [B, S] in; ahat / bhat [T, B, S] and cfw [T, B]
    out, as each returns them: the TPU forms pad S to 128 lanes and
    broadcast cfw over them, padding that is not work the function needs),
    and ~12 float32 operations per (frame, lane, speaker) for the fused
    walk's two chains, ~6 for one chain."""
    tbs, bs, tb = T * B * S * 4, B * S * 4, T * B * 4
    nbytes, ops = {
        # K3 _fused_kernel: w, col, pinit in; ahat, bhat out
        "fb_scan_fused": (3 * tbs + 2 * bs, 12),
        # K4 _fwd_kernel: w, col, pinit in; ahat, cfw out
        "fb_scan_fwd": (2 * tbs + 2 * bs + tb, 6),
        # K5 _bwd_kernel: w (one-frame-shifted), col in; bhat out
        "fb_scan_bwd": (2 * tbs + bs, 6)}[kernel]
    return _bound(nbytes, ops * T * B * S)


# K1 (B, T, S): the bench shape and the solo long recording
K1_SHAPES = ((256, 1025, 31), (4, 32768, 8))
# K2 (B, Tb, S, R): chip_smoke.py's K2_SHAPES
K2_SHAPES = ((4, 8192, 8, 16), (4, 2048, 31, 4), (2, 1024, 128, 2),
             (3, 96, 8, 4), (2, 300, 8, 3))


def k1_bound(B: int, T: int, S: int, esize: int) -> dict:
    """K1 _fused_kernel_sb: w [B, T, S] (esize bytes a value) in, ahat and
    bhat out in the same type, cfw [B, T] float32 out, col / pinit / binit
    [B, S] float32 in; ~12 float32 operations per (lane, frame, speaker)."""
    nbytes = 3 * B * T * S * esize + B * T * 4 + 3 * B * S * 4
    return _bound(nbytes, 12 * B * T * S)


def k2_bound(B: int, Tb: int, S: int, R: int, esize: int) -> dict:
    """K2 _fwd_product_kernel_sb: w [B, Tb, S] and col [B, S] in, finit
    [R, B, S, S] in and fhat out, ls [R, B, S] out (float32 but w); ~5
    float32 operations per (lane, row, frame, speaker)."""
    nbytes = (B * Tb * S * esize + B * S * 4 + 2 * R * B * S * S * 4
              + R * B * S * 4)
    return _bound(nbytes, 5 * B * Tb * S * S)


def walk_bound_ms(steps: int, rows: int, n: int, d: int) -> float:
    """The NN-chain walk (csrc/nn_chain.cu) as chip_smoke.py bounds it: the
    bytes a walk read (each step the sum rows and sizes of its live
    clusters, `rows` their count summed over the steps as the kernel
    counts it, and the lane's n active flags) over the HBM rate. The
    steps and rows depend on the data: a walk's own counts give them."""
    return (rows * (d + 1) * 8 + steps * n * 4) / HBM_BYTES_PER_S * 1e3


def _bound(nbytes: int, ops: int) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def main() -> int:
    rows = []
    for esize, io in ((4, "float32"), (2, "bfloat16")):
        for B, T, S in K1_SHAPES:
            rows.append({"kernel": f"K1 _fused_kernel_sb {io}",
                         "B,T,S": [B, T, S], **k1_bound(B, T, S, esize)})
        for B, Tb, S, R in K2_SHAPES:
            rows.append({"kernel": f"K2 _fwd_product_kernel_sb {io}",
                         "B,Tb,S,R": [B, Tb, S, R],
                         **k2_bound(B, Tb, S, R, esize)})
    for r in rows:
        shape = next(f"{k}={','.join(map(str, v))}" for k, v in r.items()
                     if k.startswith("B,"))
        print(f"{r['kernel']} at {shape}: {r['bytes']} bytes, bound "
              f"{r['bound_ms'] * 1e3:.4f} us ({r['bound_by']})")
    for T, S, B in SHAPES:
        for kernel, name in SCAN_KERNELS.items():
            rows.append({"kernel": name, "T,S,B": [T, S, B],
                         **scan_bound(T, B, S, kernel)})
            r = rows[-1]
            print(f"{name} at T,S,B={T},{S},{B}: {r['bytes']} bytes, bound "
                  f"{r['bound_ms'] * 1e3:.4f} us ({r['bound_by']})")
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
