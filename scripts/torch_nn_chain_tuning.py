#!/usr/bin/env python3
"""Time variants of the NN-chain walk kernel on one CUDA card
(vbx_tpu_torch/csrc/nn_chain.cu), and the card's L2 read rate.

    python3 scripts/torch_nn_chain_tuning.py [summary.json] [--only TAG,...]

Each variant is the shipped source with a few lines replaced by text
substitution (VARIANTS below): the owners' rows all read through L2 (or
held in shared memory where they fit, as shipped); the spin on the
exchange's tags without its `__nanosleep`; a full fence before the tag's
release store; a relaxed poll with one fence after it; each block's
records read by the thread that polled its tag, with no barrier between;
128 or 512 threads a block; 2 or 8 lanes a row instead of 4 (order_: the
dots are summed in another order, so the merges may differ); the
division by a reciprocal (diag_: other bits, for the breakdown only);
and one with clock64() timers in thread 0 of every block, held in
registers, that split a step into its phases (scan, publication, polls,
records, the replica's update, staging), summed over the steps. Every
variant runs at one and at two blocks an SM, at N = 256 / 6144 / 10000 /
16384 (D = 128, 8 clusters, chip_smoke.py's inputs) and on the batch of
four lanes 6144-12000 in one launch; the times are the host clock around
a synchronized launch through clustering/device.py:walk_on_card (median
of 3 after a warm-up round, variants in turns), and each variant's
merges are checked equal to the shipped source's. Variants are compiled
first, one nvcc for each, started together.

The L2 rate: a kernel that reads a 16 MB buffer (it stays in the 50 MB L2)
over and over, and the same on a 1 GB buffer (HBM), by CUDA events; the
walk's bound is stated at both rates.

It prints the card's name and power limit first; the JSON summary (its
last line) is also written to the file named as the argument, if any. A
measurement tool: nothing in the package uses these variants, and only
the shipped source is held to the plain twin (chip_smoke.py,
tests/test_torch_gpu.py).
"""

import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NS = (256, 6144, 10000, 16384)
BATCH_NS = (6144, 8000, 10000, 12000)
D = 128
BLOCKS_PER_SM = (1, 2)


def _set_const(name, value):
    """A substitution that sets `constexpr ... name = value;`."""
    def sub(src):
        pat = re.compile(rf"(constexpr \w+ {name} = )[^;]+;")
        if not pat.search(src):
            raise RuntimeError(f"constant {name} not found in the source")
        return pat.sub(rf"\g<1>{value};", src, count=1)
    return sub


def _replace(old, new):
    def sub(src):
        if old not in src:
            raise RuntimeError(f"text to replace not found in the source: "
                               f"{old!r}")
        return src.replace(old, new)
    return sub


_RELEASE = "        st_release(w.tags + slot * w.cap + blockIdx.x, e);"
_RECORDS = ("      __syncthreads();\n"
            "      for (int l0 = 0; l0 < mg; l0 += kLanesAtOnce) {\n")
_PHASE = ("if (threadIdx.x == 0) {{ const long long t_now = clock64(); "
          "ph[{k}] += t_now - t_ph; t_ph = t_now; }}")
# the step's phases, timed in thread 0 of every block (in registers,
# stored once at the end): the name of each phase and the text it ends
# before. The staging of step e ends where step e + 1 begins.
_PHASE_ENDS = (
    ("top", "      scan_lanes(w, g0, mg"),
    ("scan", "      __syncthreads();\n\n      // publish: the block's"),
    ("scan_barrier", "      // publish: the block's"),
    ("publish", "      // acquire: thread j polls block j's tag"),
    ("poll", "      __syncthreads();\n      for (int l0 = 0; l0 < mg; "
             "l0 += kLanesAtOnce)"),
    ("poll_barrier", "      for (int l0 = 0; l0 < mg; l0 += kLanesAtOnce)"),
    ("records", "      // the step's decision and the next step's staging"),
    ("lane_update", "      // the rows: the new tip's and predecessor's"),
    ("rows", "      if (lt < mg) {\n        if (N.live) {"),
    ("stage_barrier", "      Lane* cur = lanes2 + (e & 1) * w.Mg;\n"))
PHASES = tuple(name for name, _ in _PHASE_ENDS)
_PHASE_API = """
extern "C" int nn_chain_phases(long long* host, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(host, nn_phase, sizeof(nn_phase));
  static long long zeros[kPhaseBlocks * 16];
  if (e == cudaSuccess && reset)
    e = cudaMemcpyToSymbol(nn_phase, zeros, sizeof(nn_phase));
  return static_cast<int>(e);
}
"""


def _phase_timers(src):
    src = _replace(
        "__global__ void __launch_bounds__(kThreads, 2) nn_chain_kernel",
        "constexpr int kPhaseBlocks = 1024;\n"
        "__device__ long long nn_phase[kPhaseBlocks * 16];\n\n"
        "__global__ void __launch_bounds__(kThreads, 2) nn_chain_kernel")(src)
    src = _replace("  int e = 0;  // the exchange",
                   "  long long ph[16] = {0};\n  int e = 0;  // the exchange")(
                       src)
    src = _replace("    for (;; ++e) {\n",
                   "    long long t_ph = clock64();\n    for (;; ++e) {\n")(
                       src)
    for k, (_, anchor) in enumerate(_PHASE_ENDS):
        src = _replace(anchor, "      " + _PHASE.format(k=k) + "\n"
                       + anchor)(src)
    end = "        nxt[lt] = N;\n      }\n      __syncthreads();\n    }\n  }\n"
    return _replace(end, end + "  if (threadIdx.x == 0)\n    for (int k = 0; "
                    "k < 16; ++k) nn_phase[blockIdx.x * 16 + k] = ph[k];\n")(
                        src) + _PHASE_API


VARIANTS = {
    "shipped": (),
    "rows_shared": (_set_const("kOwnRowsInShared", "true"),),
    "rows_l2": (_set_const("kOwnRowsInShared", "false"),),
    "no_sleep": (_replace("void spin_pause() { __nanosleep(32); }",
                          "void spin_pause() {}"),),
    "fence": (_replace(_RELEASE, "        __threadfence();\n" + _RELEASE),),
    "relaxed_poll": (
        _replace('asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"',
                 'asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];"'),
        _replace(_RECORDS, '      asm volatile("fence.acq_rel.gpu;" ::: '
                 '"memory");\n' + _RECORDS)),
    "records_at_poll": (_replace(_RECORDS, _RECORDS.replace(
        "      __syncthreads();\n", "")),),
    "diag_rcp": (_replace("        const double d = -dot / (sz * na);",
                          "        const double d = -dot * __drcp_rn(sz * na);"
                          ),),
    # another summation order: other bits, the same contract
    "order_row_lanes2": (_set_const("kRowLanes", "2"),),
    "order_row_lanes8": (_set_const("kRowLanes", "8"),),
    "threads128": (_set_const("kThreads", "128"),),
    "threads512": (_set_const("kThreads", "512"),),
    "phases": (_phase_timers,),
}

_L2_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void read_kernel(const double2* x, long long n, int reps,
                            double* out) {
  double acc = 0.0;
  for (int r = 0; r < reps; ++r)
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < n; i += (long long)gridDim.x * blockDim.x) {
      const double2 v = __ldcg(x + i);
      acc += v.x + v.y;
    }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}
extern "C" int read_launch(void* x, long long n, int reps, void* out,
                           int grid, void* stream) {
  read_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const double2*)x, n, reps, (double*)out);
  return (int)cudaGetLastError();
}
"""


def variant_source(src, subs):
    for sub in subs:
        src = sub(src)
    return src


def build(work):
    """One nvcc for each variant and for the L2 reader, started together;
    {tag: library path}."""
    from vbx_tpu_torch.ops import cuda_build

    src = open(cuda_build.sources()["nn_chain"]).read()
    nvcc = cuda_build._nvcc()
    flags = [f for f in cuda_build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = []
    sources = {tag: variant_source(src, subs)
               for tag, subs in VARIANTS.items()}
    sources["l2_read"] = _L2_SOURCE
    for tag, text in sources.items():
        cu = os.path.join(work, f"{tag}.cu")
        so = os.path.join(work, f"lib{tag}.so")
        with open(cu, "w") as f:
            f.write(text)
        procs.append((tag, so, subprocess.Popen(
            [nvcc, *flags, "-o", so, cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for tag, so, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag}:\n{out}")
        libs[tag] = so
    return libs


def ahc_xn(n, seed, d=D, k=8):
    """chip_smoke.py's walk inputs."""
    import numpy as np

    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d))
    x = centers[rng.integers(0, k, n)] + 0.5 * rng.standard_normal((n, d))
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def read_rate(lib, nbytes, reps=20):
    """Bytes/s of the reader over a buffer of nbytes, read `reps` times in
    one launch after a warm-up launch (CUDA events)."""
    import torch

    fn = lib.read_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid = 8 * sms
    x = torch.ones(nbytes // 8, dtype=torch.float64, device="cuda")
    out = torch.empty(grid * 256, dtype=torch.float64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    n2 = nbytes // 16

    def run(r):
        if fn(x.data_ptr(), n2, r, out.data_ptr(), grid, stream) != 0:
            raise RuntimeError("the L2 reader failed to launch")

    run(2)
    times = []
    for _ in range(5):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        run(reps)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) * 1e-3)
    return nbytes * reps / statistics.median(times)


def main(argv=None) -> int:
    import numpy as np
    import torch

    from vbx_tpu_torch.clustering import device as cdev

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--only" in argv:   # time these variants (and the shipped source)
        i = argv.index("--only")
        keep = {"shipped", *argv[i + 1].split(",")}
        del argv[i:i + 2]
        for tag in [t for t in VARIANTS if t not in keep]:
            del VARIANTS[tag]
    if not torch.cuda.is_available():
        print("no CUDA card: this tool only measures on a card",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        libs = {tag: ctypes.CDLL(so) for tag, so in build(work).items()}
        print(f"built {len(libs)} libraries in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        summary = {"card": card, "walk": {}, "phases": {}}
        rates = {"l2_16MB": read_rate(libs["l2_read"], 16 << 20),
                 "hbm_1GB": read_rate(libs["l2_read"], 1 << 30, reps=3)}
        summary["read_rate_bytes_per_s"] = rates
        print(f"read rate: L2 (16 MB) {rates['l2_16MB'] / 1e12:.2f} TB/s, "
              f"HBM (1 GB) {rates['hbm_1GB'] / 1e12:.2f} TB/s", flush=True)

        inputs = {n: torch.from_numpy(ahc_xn(n, n))[None].cuda()
                  for n in NS}
        big = np.zeros((len(BATCH_NS), max(BATCH_NS), D))
        for m, n in enumerate(BATCH_NS):
            big[m, :n] = ahc_xn(n, 100 + n)
        inputs["batched"] = torch.from_numpy(big).cuda()
        ns_of = {n: [n] for n in NS}
        ns_of["batched"] = list(BATCH_NS)

        def walk(tag, key, bps):
            fn = cdev._bind(libs[tag].nn_chain_walk_launch)
            return cdev.walk_on_card(fn, inputs[key], ns_of[key], bps)

        ref = {key: walk("shipped", key, 1)[0] for key in inputs}
        for key in inputs:
            out = ref[key]
            steps = [int(s) for s in out[4].cpu()]
            rows = [int(r) for r in out[5].cpu()]
            ns = ns_of[key]
            hbm = sum(r * (D + 1) * 8 + s * n * 4
                      for r, s, n in zip(rows, steps, ns))
            summary["walk"][str(key)] = {
                "steps": steps, "rows": rows,
                "bound_ms_hbm": hbm / 3.35e12 * 1e3,
                "bound_ms_l2": hbm / rates["l2_16MB"] * 1e3, "ms": {}}
        # in turns: every variant once a round, three rounds
        rounds, refused = {}, set()
        for r in range(4):
            for tag in VARIANTS:
                for bps in BLOCKS_PER_SM:
                    if (tag, bps) in refused:
                        continue
                    for key in inputs:
                        torch.cuda.synchronize()
                        t = time.perf_counter()
                        try:
                            out, grid, group = walk(tag, key, bps)
                        except RuntimeError as err:
                            # a variant whose registers or shared memory
                            # do not fit this many blocks an SM
                            print(f"{tag} at {bps} blocks an SM: {err}",
                                  flush=True)
                            refused.add((tag, bps))
                            break
                        ms = (time.perf_counter() - t) * 1e3
                        if r == 0:   # warm-up round: check the merges
                            same = all(torch.equal(out[j], ref[key][j])
                                       for j in range(6))
                            # a diag_ variant times a change of arithmetic
                            # (other bits), for the breakdown only; an
                            # order_ variant sums the dots in another order
                            if not same and not tag.startswith(
                                    ("diag_", "order_")):
                                raise RuntimeError(
                                    f"variant {tag} at {bps} blocks an SM, "
                                    f"{key}: other merges than the shipped "
                                    f"source's")
                            continue
                        rounds.setdefault((tag, bps, key), []).append(ms)
        summary["refused"] = sorted(f"{t}/{b}" for t, b in refused)
        for (tag, bps, key), ts in rounds.items():
            w = summary["walk"][str(key)]
            ms = statistics.median(ts)
            w["ms"][f"{tag}/{bps}"] = ms
            us = ms * 1e3 / max(w["steps"])
            print(f"{tag:12s} {bps} block(s)/SM  {str(key):8s} {ms:8.1f} ms"
                  f"  {us:6.2f} us a step (longest lane)", flush=True)

        # the phases of a step, summed over the steps, every block
        buf = np.zeros(1024 * 16, np.int64)
        for tag in (t for t in VARIANTS if t.startswith("phases")):
            lib = libs[tag]
            lib.nn_chain_phases.restype = ctypes.c_int
            lib.nn_chain_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
            for bps in BLOCKS_PER_SM:
                for key in inputs:
                    lib.nn_chain_phases(buf.ctypes.data, 1)
                    _, grid, _ = walk(tag, key, bps)
                    if lib.nn_chain_phases(buf.ctypes.data, 0) != 0:
                        raise RuntimeError("reading the phase timers failed")
                    ph = buf.reshape(1024, 16)[:grid, :len(PHASES)]
                    steps = max(summary["walk"][str(key)]["steps"])
                    per = {name: {"mean": float(ph[:, k].mean()) / steps,
                                  "max": float(ph[:, k].max()) / steps,
                                  "block0": float(ph[0, k]) / steps}
                           for k, name in enumerate(PHASES)}
                    summary["phases"][f"{tag}/{key}/{bps}"] = per
                    print(f"{tag} {str(key):8s} {bps}/SM cycles a step "
                          f"(mean over blocks / max / block 0): " + ", ".join(
                              f"{name} {v['mean']:.0f}/{v['max']:.0f}/"
                              f"{v['block0']:.0f}" for name, v in per.items()),
                          flush=True)
    summary["seconds"] = time.perf_counter() - t0
    line = json.dumps(summary)
    if argv:
        os.makedirs(os.path.dirname(os.path.abspath(argv[0])), exist_ok=True)
        with open(argv[0], "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
