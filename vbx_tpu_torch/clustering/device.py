"""NN-chain average linkage on the card over the cluster-sums identity (port
of vbx_tpu.clustering.device).

With average linkage over d(i, j) = -(x_i . x_j), the distance of two
clusters is -(S_a . S_x) / (|a| |x|), S a cluster's row sum: every
nearest-neighbour scan of Muellner's chain is one [N, D] matrix-vector
product over the cluster sums, and a merge is S_b += S_a. vbx_tpu walks the
chain as one XLA while_loop (_nn_chain_batched_jit); the port walks it in
one cooperative CUDA kernel (csrc/nn_chain.cu, its note has the design),
every lane of a batch to its end in one launch, and only the merge
triples come back to the host.

Parity contract: the scan order, the lowest index on ties and the chain
predecessor's tie preference mirror vbx_tpu's lane body and the host
chain. The arithmetic is float64, the host chain's, where vbx_tpu's walk
is float32 (its TPU has no float64): a float32 walk settles merges closer
than ~1e-7 by rounding, and at N = 16384 that changed a cluster of the
dendrogram on the H100 (csrc/nn_chain.cu). So the walk's merge distances
agree with the host chain's to float64 rounding, and with vbx_tpu's walk
to float32's (tests/test_torch_clustering_device.py).

Failure containment: NN-chain correctness rests on reducibility, which
rounding can break at pathological near-ties; a lane whose chain
tip is a cluster that has merged away sets its `bad` flag and stops, and
the wrappers raise ReducibilityError. The AHC routes fall back to the host
float64 chain on that error alone: a kernel that fails to build or launch,
or a CUDA error, propagates.

`nn_chain_walk` launches the kernel for CUDA tensors; for CPU tensors it
runs `nn_chain_walk_plain`, the same lane body as a Python loop over steps
(the tests' reference and the card's yardstick). Device walks are
serialized by one lock: vbx_tpu's single device runs them one at a time,
and the walk fills the card by construction (a cooperative launch).
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from vbx_tpu_torch.device import DeviceLike, resolve_device
from vbx_tpu_torch.ops import cuda_build
from vbx_tpu_torch.utils.profiling import annotate

MAX_D = 4096          # csrc/nn_chain.cu: kMaxD
_MAX_GROUP = 32       # csrc/nn_chain.cu: kMaxGroup, lanes walked at once
_SHARED_BYTES = 232448  # an H100 block's shared memory (opt-in)
_WALK_LOCK = threading.Lock()


class ReducibilityError(RuntimeError):
    """The walk's reducibility guard tripped on at least one lane (a
    near-tie broke the chain invariant); the host chain is the answer for
    such a recording."""


def _bind(fn):
    """Set the argument types of a nn_chain_walk_launch entry point."""
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p]
                       + [ctypes.POINTER(ctypes.c_int)] * 2)
    return fn


def _launcher():
    return _bind(cuda_build.library("nn_chain").nn_chain_walk_launch)


def lane_shared_bytes(Np: int, D: int) -> int:
    """Shared memory one lane takes in every block of the walk kernel
    (csrc/nn_chain.cu:Layout): the staged tip and predecessor rows, the
    8 warps' partials of the scan and of the exchange, two copies of the
    replicated bookkeeping (96 bytes each) and the active set as a
    bitmap."""
    return 2 * D * 8 + 2 * 8 * (8 + 4) + 2 * 96 + 4 * (-(-Np // 32))


def exchange_blocks(sms: int, blocks_per_sm: int) -> int:
    """Blocks the exchange scratch is sized for: the kernel's grid is
    blocks_per_sm (0: its default, 1) blocks on each of `sms` SMs."""
    return max(blocks_per_sm, 2) * sms


def _check_walk_shape(Np: int, D: int) -> None:
    if D > MAX_D:
        raise ValueError(f"D={D} > {MAX_D}: the walk kernel stages the tip's "
                         f"and the predecessor's rows in shared memory")
    if lane_shared_bytes(Np, D) > _SHARED_BYTES:
        raise ValueError(f"N={Np}, D={D}: a lane's rows and active set do "
                         f"not fit one block's shared memory "
                         f"({_SHARED_BYTES} bytes)")


def walk_on_card(fn, sums: torch.Tensor, ns: Sequence[int],
                 blocks_per_sm: int = 0):
    """Launch a nn_chain_walk_launch entry point `fn` (the shipped kernel's
    or a variant's) on CUDA `sums` [M, Np, D] float64 and wait for it.
    Returns ((ma, mb, md, bad, steps, rows), grid, lanes walked at once);
    raises RuntimeError if the launch fails."""
    M, Np, D = sums.shape
    _check_walk_shape(Np, D)
    Np2 = max(Np, 2)
    dev = sums.device
    x = torch.zeros((M, Np2, D), dtype=torch.float64, device=dev)
    x[:, :Np] = sums
    sizes = torch.ones((M, Np2), dtype=torch.float64, device=dev)
    n_t = torch.tensor(ns, dtype=torch.int32, device=dev)
    chain = torch.zeros((M, Np2 + 2), dtype=torch.int32, device=dev)
    chain_d = torch.zeros((M, Np2 + 2), dtype=torch.float64, device=dev)
    ma = torch.zeros((M, Np2 - 1), dtype=torch.int32, device=dev)
    mb = torch.zeros_like(ma)
    md = torch.zeros((M, Np2 - 1), dtype=torch.float64, device=dev)
    bad = torch.zeros(M, dtype=torch.int32, device=dev)
    steps = torch.zeros(M, dtype=torch.int32, device=dev)
    rows_read = torch.zeros(M, dtype=torch.int64, device=dev)
    cap = exchange_blocks(
        torch.cuda.get_device_properties(dev).multi_processor_count,
        blocks_per_sm)
    # 16-byte (distance, index) records, two slots; tags -1: no step yet
    recs = torch.empty((2, cap, _MAX_GROUP, 2), dtype=torch.float64,
                       device=dev)
    tags = torch.full((2, cap), -1, dtype=torch.int32, device=dev)
    grid, group = ctypes.c_int(0), ctypes.c_int(0)
    with _WALK_LOCK, torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(x.data_ptr(), sizes.data_ptr(), n_t.data_ptr(),
                chain.data_ptr(), chain_d.data_ptr(), ma.data_ptr(),
                mb.data_ptr(), md.data_ptr(),
                bad.data_ptr(), steps.data_ptr(), rows_read.data_ptr(),
                recs.data_ptr(), tags.data_ptr(), M, Np2, D, cap,
                int(blocks_per_sm), stream, ctypes.byref(grid),
                ctypes.byref(group))
        if rc != 0:
            raise RuntimeError(f"nn_chain_walk kernel launch failed: CUDA "
                               f"error {rc} (M={M}, N={Np}, D={D})")
        # the walk holds the card: finish it inside the lock
        torch.cuda.current_stream(dev).synchronize()
    k = Np - 1 if Np >= 1 else 0
    return ((ma[:, :k], mb[:, :k], md[:, :k], bad != 0, steps, rows_read),
            grid.value, group.value)


def nn_chain_walk(sums: torch.Tensor, ns: Sequence[int],
                  blocks_per_sm: int = 0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor, torch.Tensor, torch.Tensor]:
    """Walk every lane's NN chain to its end.

    sums: [M, Np, D] float64, lane m's first ns[m] rows its l2-normalized
    x-vectors (the rest unused). Returns (ma, mb [M, Np - 1] int32, md
    [M, Np - 1] float64: merge triples in chain order, the first ns[m] - 1
    of each lane valid; bad [M] bool; steps [M] int32; rows [M] int64, the
    live clusters summed over the lane's scans, whose sum rows a step
    reads), on sums' device.
    CUDA tensors launch csrc/nn_chain.cu (one launch for all lanes;
    `blocks_per_sm` picks the grid, 0 the kernel's default, and does not
    change the result); CPU tensors run nn_chain_walk_plain. Either way
    the walk's lanes, steps and rows join the counters that
    `walk_counters` reads."""
    if sums.dim() != 3 or sums.dtype != torch.float64:
        raise ValueError(f"sums must be float64 [M, Np, D], got {sums.dtype} "
                         f"{tuple(sums.shape)}")
    M, Np, D = sums.shape
    ns = [int(n) for n in ns]
    if len(ns) != M or any(n < 0 or n > Np for n in ns):
        raise ValueError(f"ns must give 0 <= n <= {Np} for each of {M} lanes")
    if int(blocks_per_sm) < 0:
        raise ValueError(f"blocks_per_sm must be >= 0 (0: the kernel's "
                         f"default), got {blocks_per_sm}")
    if sums.device.type == "cpu":
        out = nn_chain_walk_plain(sums, ns)
        _count(out, ns, D, launched=False)
        return out
    if sums.device.type != "cuda":
        raise ValueError(f"nn_chain_walk runs on cuda or cpu, not "
                         f"{sums.device}")
    out, grid, group = walk_on_card(_launcher(), sums, ns, blocks_per_sm)
    nn_chain_walk.grid = grid
    nn_chain_walk.group = group
    _count(out, ns, D, launched=True)
    return out


nn_chain_walk.launches = 0   # kernel launches since the caller last reset it
nn_chain_walk.grid = 0       # blocks of the last launch
nn_chain_walk.group = 0      # lanes the last launch walked at once
# cumulative over every walk, the kernel's and the CPU twin's: lanes, their
# steps and rows read (as the walk counts them), and steps x the lane's n;
# with D, what a walk read (scripts/kernel_bounds.py:walk_bound_ms)
nn_chain_walk.lanes = 0
nn_chain_walk.steps = 0
nn_chain_walk.rows = 0
nn_chain_walk.step_n = 0
nn_chain_walk.D = 0          # the feature dim of the last walk
_WALK_COUNTERS = ("launches", "lanes", "steps", "rows", "step_n")
# the counters' owner, by reference: a wrapper installed under the name
# nn_chain_walk (a test's spy) neither hides nor splits them
_WALK_FN = nn_chain_walk


def _count(out, ns: Sequence[int], D: int, launched: bool) -> None:
    """Add a finished walk's lanes, steps and rows (from the tensors it
    returned: one small copy to the host) to nn_chain_walk's counters."""
    steps, rows = torch.stack([out[4].to(torch.int64), out[5]]).cpu().numpy()
    with _WALK_LOCK:
        _WALK_FN.launches += int(launched)
        _WALK_FN.lanes += len(ns)
        _WALK_FN.steps += int(steps.sum())
        _WALK_FN.rows += int(rows.sum())
        _WALK_FN.step_n += int(steps @ np.asarray(ns, np.int64))
        _WALK_FN.D = D


def walk_counters(since: Optional[dict] = None) -> dict:
    """A snapshot of nn_chain_walk's cumulative counters; given an earlier
    snapshot, the counts since it, and `D`, the feature dim of the last
    walk."""
    with _WALK_LOCK:
        now = {k: getattr(_WALK_FN, k) for k in _WALK_COUNTERS}
        if since is None:
            return now
        return {**{k: v - since[k] for k, v in now.items()},
                "D": _WALK_FN.D}


def nn_chain_walk_plain(sums: torch.Tensor, ns: Sequence[int]
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor, torch.Tensor, torch.Tensor]:
    """nn_chain_walk's lane body as a Python loop over steps, on sums'
    device: the same rules, order and float64 arithmetic
    (d = -dot / (|x| |a|)); the dot products are summed in torch's order,
    not the kernel's."""
    M, Np, D = sums.shape
    dev = sums.device
    k_max = max(Np - 1, 0)
    ma = torch.zeros((M, k_max), dtype=torch.int32)
    mb = torch.zeros_like(ma)
    md = torch.zeros((M, k_max), dtype=torch.float64)
    bad = torch.zeros(M, dtype=torch.bool)
    steps = torch.zeros(M, dtype=torch.int32)
    rows_read = torch.zeros(M, dtype=torch.int64)
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=dev)
    for m, n in enumerate(int(v) for v in ns):
        if n < 2:
            continue
        S = sums[m, :n].clone()
        sizes = torch.ones(n, dtype=torch.float64, device=dev)
        active = torch.ones(n, dtype=torch.bool, device=dev)
        act = np.ones(n, bool)          # host copy for the chain's checks
        idx = torch.arange(n, device=dev)
        chain: List[int] = [0]
        first = k = step = 0
        while k < n - 1:
            a = chain[-1]
            if not act[a] or step >= 4 * n + 4:
                bad[m] = True
                break
            na = sizes[a]
            dist = -(S @ S[a]) / (sizes * na)
            dist = torch.where(active & (idx != a), dist, inf)
            b0 = int(torch.argmin(dist))       # the first minimal index
            dmin = float(dist[b0])
            merge = False
            if len(chain) >= 2:
                prev = chain[-2]
                dprev = float(dist[prev])
                merge = dprev <= dmin
            step += 1
            rows_read[m] += n - k
            if merge:
                ma[m, k], mb[m, k], md[m, k] = a, prev, dprev
                k += 1
                S[prev] += S[a]
                sizes[prev] += sizes[a]
                active[a] = False
                act[a] = False
                chain = chain[:-2]
                if not chain and k < n - 1:
                    while first < n - 1 and not act[first]:
                        first += 1
                    chain = [first]
            else:
                chain.append(b0)
        steps[m] = step
    return (ma.to(dev), mb.to(dev), md.to(dev), bad.to(dev), steps.to(dev),
            rows_read.to(dev))


def linkage_dot_avg_device(xn: np.ndarray, device: DeviceLike = None
                           ) -> np.ndarray:
    """Average linkage over d(i, j) = -(x_i . x_j) with the NN-chain walk on
    `device` ('cuda' unless the caller passes 'cpu'). xn: [N, D]
    l2-normalized rows. Returns the SciPy-compatible [N-1, 4] linkage
    matrix; raises ReducibilityError when the guard trips."""
    return linkage_dot_avg_device_batched([xn], device=device)[0]


def linkage_dot_avg_device_batched(xns, device: DeviceLike = None) -> list:
    """The walk over a list of [N_i, D] matrices (one recording each, shared
    D), every lane in one kernel launch. Returns one SciPy linkage matrix per
    input. Raises ReducibilityError, with vbx_tpu's text, if any lane's
    reducibility guard trips."""
    xns = [np.ascontiguousarray(x, dtype=np.float64) for x in xns]
    if not xns:
        return []
    D = xns[0].shape[1]
    if any(x.shape[1] != D for x in xns):
        raise ValueError("all recordings must share the feature dim")
    dev = resolve_device(device)
    M = len(xns)
    ns = [x.shape[0] for x in xns]
    Np = max(ns)
    with annotate("vbx.ahc.walk"):
        sums0 = np.zeros((M, Np, D), np.float64)
        for m, x in enumerate(xns):
            sums0[m, :ns[m]] = x
        ma, mb, md, bad = nn_chain_walk(torch.from_numpy(sums0).to(dev),
                                        ns)[:4]
        bad = bad.cpu().numpy()
        if bad.any():
            raise ReducibilityError(
                f"device NN-chain reducibility guard tripped on "
                f"{int(bad.sum())}/{M} recording(s) (f32 near-tie broke "
                f"the chain invariant); use the host f64 chain")
        ma, mb, md = ma.cpu().numpy(), mb.cpu().numpy(), md.cpu().numpy()
    out = []
    with annotate("vbx.ahc.finalize"):
        for m, n in enumerate(ns):
            if n < 2:
                out.append(np.empty((0, 4), np.float64))
            else:
                out.append(_finalize(ma[m, :n - 1], mb[m, :n - 1],
                                     md[m, :n - 1], n))
    return out


def _finalize(ma: np.ndarray, mb: np.ndarray, md: np.ndarray, n: int
              ) -> np.ndarray:
    """Merge triples (chain order) -> SciPy linkage matrix: stable sort by
    distance (keeps NN-chain order on ties — valid by reducibility) +
    union-find relabeling, exactly native finalize_linkage's semantics."""
    order = np.argsort(md, kind="stable")
    a_s, b_s, d_s = ma[order], mb[order], md[order]
    parent = np.full(2 * n - 1, -1, np.int64)
    size = np.ones(2 * n - 1, np.int64)

    def find(x):
        root = x
        while parent[root] != -1:
            root = parent[root]
        while parent[x] != -1:
            parent[x], x = root, parent[x]
        return root

    Z = np.empty((n - 1, 4), np.float64)
    for k in range(n - 1):
        la, lb = find(a_s[k]), find(b_s[k])
        if la > lb:
            la, lb = lb, la
        label = n + k
        parent[la] = label
        parent[lb] = label
        size[label] = size[la] + size[lb]
        Z[k] = (la, lb, d_s[k], size[label])
    return Z
