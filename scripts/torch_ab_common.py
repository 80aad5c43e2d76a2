"""What the port's A/B drivers (scripts/torch_ab_*.py) share: their log,
the timing of one run between synchronizations, the launch counters of
the kernels they reach, and K1 timed alone at a run's shape beside its
bound (scripts/kernel_bounds.py's).

Not a driver: it parses no arguments and runs nothing when imported.
"""

import statistics
import sys
import time

from kernel_bounds import k1_bound


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def sync(devices):
    """Wait for every CUDA card among `devices` (one device or a list)."""
    import torch

    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    for d in {torch.device(d) for d in devices}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def timed_runs(fn, devices, reps: int):
    """fn() `reps` times, each run between synchronizations of `devices`
    (a host clock around work that ends in torch.cuda.synchronize; the
    host's clock alone with the CPU). Returns (seconds of each run, the
    last run's result)."""
    times, res = [], None
    for _ in range(reps):
        sync(devices)
        t0 = time.perf_counter()
        res = fn()
        sync(devices)
        times.append(time.perf_counter() - t0)
    return times, res


def kernels():
    """The wrappers whose `launches` count the kernels the drivers reach:
    {'K1': fb_fused_sb, 'K2': fb_fwd_product_sb, 'walk': nn_chain_walk}."""
    from vbx_tpu_torch.clustering.device import nn_chain_walk
    from vbx_tpu_torch.ops.fb_kernel import fb_fused_sb
    from vbx_tpu_torch.ops.fb_product_kernel import fb_fwd_product_sb

    return {"K1": fb_fused_sb, "K2": fb_fwd_product_sb,
            "walk": nn_chain_walk}


def reset_launches():
    for k in kernels().values():
        k.launches = 0


def read_launches() -> dict:
    return {name: k.launches for name, k in kernels().items()}


def k1_alone(B: int, T: int, S: int, io_dtype, device, n: int = 25) -> dict:
    """K1 (ops.fb_kernel.fb_fused_sb) alone at [B, T, S] on random weights:
    the median of `n` launches by CUDA events after a warm-up, beside its
    bound. These launches are the caller's to leave out of a run's count
    (read the counters first)."""
    import torch

    from vbx_tpu_torch.ops.fb_kernel import fb_fused_sb

    gen = torch.Generator(device=device).manual_seed(0)
    # the engine's weights: exp(log_p - max_s log_p), in (0, 1]
    w = (torch.rand((B, T, S), generator=gen, device=device) + 1e-3
         ).clamp(max=1.0).to(io_dtype)
    pi = torch.full((B, S), 1.0 / S, device=device)
    col, pinit = 0.1 * pi + 1e-8, pi + 1e-8

    def call():
        # recip=True: the engine's mode (engine.vbhmm._em_kernel)
        return fb_fused_sb(w, col, pinit, pi, 0.9, recip=True)

    for _ in range(3):
        call()
    times = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        call()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    esize = torch.empty((), dtype=io_dtype).element_size()
    return {"shape": [B, T, S], "dtype": str(io_dtype).split(".")[-1],
            "ms": statistics.median(times), **k1_bound(B, T, S, esize)}
