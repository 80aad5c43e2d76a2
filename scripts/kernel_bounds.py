#!/usr/bin/env python3
"""Least times on an H100 for K3-K5 of vbx_tpu/ops/fb_pallas.py (the
[T, B, S] layout; ported as vbx_tpu_torch/csrc/fb_scan_tbs.cu), at the
shapes tests/test_pallas.py gives them and at the kernel A/B tool's shape
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


def kernel_bytes(T: int, S: int, B: int) -> dict:
    """Bytes each kernel's function must move: w [T, B, S], col and pinit
    [B, S] in; ahat / bhat [T, B, S] and cfw [T, B] out, as each returns
    them (the TPU forms pad S to 128 lanes and broadcast cfw over them;
    that padding is not work the function needs)."""
    tbs, bs, tb = T * B * S * 4, B * S * 4, T * B * 4
    return {
        # K3 _fused_kernel: w, col, pinit in; ahat, bhat out
        "K3 _fused_kernel": 3 * tbs + 2 * bs,
        # K4 _fwd_kernel: w, col, pinit in; ahat, cfw out
        "K4 _fwd_kernel": 2 * tbs + 2 * bs + tb,
        # K5 _bwd_kernel: w (one-frame-shifted), col in; bhat out
        "K5 _bwd_kernel": 2 * tbs + bs,
    }


# float32 operations per (frame, lane, speaker): the fused walk's two
# chains as K1's (~12), one chain for each two-pass kernel (~6)
OPS_PER_ELEMENT = {"K3 _fused_kernel": 12, "K4 _fwd_kernel": 6,
                   "K5 _bwd_kernel": 6}


def main() -> int:
    rows = []
    for T, S, B in SHAPES:
        for name, nbytes in kernel_bytes(T, S, B).items():
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = OPS_PER_ELEMENT[name] * T * B * S / F32_OPS_PER_S * 1e3
            rows.append({"kernel": name, "T,S,B": [T, S, B], "bytes": nbytes,
                         "bound_ms": max(t_bytes, t_ops),
                         "bound_by": "bytes" if t_bytes >= t_ops
                         else "operations"})
            print(f"{name} at T,S,B={T},{S},{B}: {nbytes} bytes, bound "
                  f"{max(t_bytes, t_ops) * 1e3:.4f} us "
                  f"({rows[-1]['bound_by']})")
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
