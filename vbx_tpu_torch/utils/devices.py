"""Accelerator probe and picker for launcher scripts (port of
vbx_tpu.utils.devices; the reference's free_gpu.sh:54-82 picks an idle
GPU through nvidia-smi).

The probe runs a tiny CUDA matmul in a SUBPROCESS under a timeout: a card
that hangs or a broken driver cannot then hang the caller, and the
subprocess's CUDA context goes away with it. `pick_backend()` turns the
answer into 'cuda' or 'cpu', the device a launcher script passes to the
port's entry points (`--device`). That is a launcher's choice, made before
any work starts; the entry points themselves never move to the CPU on
their own (vbx_tpu_torch.device).

    python -m vbx_tpu_torch.utils.devices [--timeout S]

prints one JSON line {"backend", "usable", "devices", "probe_s", "error"}
and exits 0 iff a card is usable (1 otherwise), so shell recipes can gate
as the reference's `gpus=$(free_gpu.sh)` does.

`measured_on` is the measurement scripts' (scripts/torch_*_bench.py)
check of their `--device`: a card unless the caller asked for the CPU.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import Optional

_PROBE = ("import torch; "
          "ok = torch.cuda.is_available(); "
          "n = torch.cuda.device_count() if ok else 0; "
          "x = float((torch.ones(64, 64, device='cuda') "
          "@ torch.ones(64, 64, device='cuda'))[0, 0]) if ok else 0.0; "
          "print('cuda' if ok else 'cpu', n, x)")


def probe_accelerator(timeout_s: float = 120.0) -> dict:
    """Probe the CUDA card in a subprocess. Returns {backend, usable,
    devices, probe_s, error}: usable=False means no card, or the probe timed
    out or crashed."""
    t0 = time.perf_counter()
    try:
        r = subprocess.run([sys.executable, "-c", _PROBE],
                           timeout=timeout_s, capture_output=True,
                           text=True)
    except subprocess.TimeoutExpired:
        return {"backend": None, "usable": False, "devices": 0,
                "probe_s": round(time.perf_counter() - t0, 2),
                "error": f"probe timed out after {timeout_s:.0f}s (the "
                         f"card or its driver is unresponsive)"}
    dt = round(time.perf_counter() - t0, 2)
    if r.returncode != 0:
        return {"backend": None, "usable": False, "devices": 0,
                "probe_s": dt,
                "error": (r.stderr or "probe crashed").strip()[-400:]}
    backend, n_dev, val = r.stdout.split()[:3]
    ok = backend == "cuda" and float(val) == 64.0
    return {"backend": backend, "usable": ok, "devices": int(n_dev),
            "probe_s": dt,
            "error": None if backend == "cuda" else "no CUDA device"}


def pick_backend(timeout_s: float = 120.0) -> str:
    """The device a new worker process should be given: 'cuda' when a card
    answers the probe, else 'cpu'."""
    info = probe_accelerator(timeout_s)
    return "cuda" if info["usable"] else "cpu"


def card_line() -> str:
    """The first card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def measured_on(device: str, prog: str) -> Optional[str]:
    """What a measurement script's figures are measured on: 'cpu' when
    `device` is 'cpu', the card's card_line() when it is 'cuda' and a card
    is visible. With 'cuda' and no card it returns None, having said on
    stderr that `--device cpu` runs `prog` on the CPU: the caller exits
    non-zero, as no figure may come from a device other than the one
    asked for."""
    if device == "cpu":
        return "cpu"
    import torch

    if not torch.cuda.is_available():
        print(f"{prog}: no CUDA device is available; pass --device cpu to "
              f"run it on the CPU explicitly", file=sys.stderr, flush=True)
        return None
    return card_line()


def main(argv: Optional[list] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    timeout_s = 120.0
    if "--timeout" in args:
        timeout_s = float(args[args.index("--timeout") + 1])
    info = probe_accelerator(timeout_s)
    print(json.dumps(info))
    return 0 if info["usable"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
