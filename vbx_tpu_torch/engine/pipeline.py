"""End-to-end diarization pipeline: transformed x-vectors -> initialization
-> VB-HMM -> merged RTTM segments (port of vbx_tpu.engine.pipeline).

Orchestration parity with the reference diarization CLI (vbhmm.py:54-179).
Recordings run one by one (streaming) or padded and batched
(`diarize_ark(..., batch=True)`), where the batched path buckets recordings
by (T, S), runs the host init chain across a thread pool and launches each
bucket's chunks through the batched engine as they fill.

A VB batch has one format, built in one place for the corpus pass, the
service (serving.py) and a single recording's kernel route:
`Diarizer.bucket_planes` pads a recording's feature and qinit planes to
its (T, S) bucket, and `run_vb_chunk` stacks a chunk of such rows, builds
its priors and masks, runs the engine with its stop rule and takes the
top-2 labels on the device. utils.bucketing.chunk_cap caps a chunk's size.

`diarize_ark(mesh=...)` routes every VB bucket through the sharded engine
(parallel.vbx_sharded): recordings over the mesh's 'dp' rows, the frames of
each recording over its 'sp' shards.

On a CUDA device the batched path first runs a corpus pre-stage: the
recordings the 'auto' AHC route sends to the card (N >=
_DEVICE_LINKAGE_MIN_N) have their NN-chain walks and calibration sweeps
batched, one walk launch and one sweep per size group
(vbx_tpu/engine/pipeline.py:508-599).

`diarize_ark(shard_over_hosts=True)` splits the corpus over the processes
of a gloo group (parallel.distributed): each host diarizes its contiguous
slice of the recordings, and process 0 concatenates their RTTMs.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vbx_tpu_torch.config import DiarizationConfig
from vbx_tpu_torch.device import DeviceLike, resolve_device, torch_dtype
from vbx_tpu_torch.engine.ahc import (
    ahc_labels, random_labels, smooth_labels_to_gamma)
from vbx_tpu_torch.engine.vbhmm import vbx, vbx_batched
from vbx_tpu_torch.io.ark import read_counters, read_vec_ark_grouped
from vbx_tpu_torch.io.plda import read_plda, rediagonalize_plda
from vbx_tpu_torch.io.rttm import merge_adjacent_labels, write_rttm
from vbx_tpu_torch.io.segments import read_xvector_timing_dict
from vbx_tpu_torch.io.transform import read_xvec_transform
from vbx_tpu_torch.parallel import distributed
from vbx_tpu_torch.parallel.mesh import Mesh, check_sp_divides_buckets
from vbx_tpu_torch.utils.bucketing import bucket_shape, chunk_cap, round_up
from vbx_tpu_torch.utils.profiling import annotate


@dataclasses.dataclass
class DiarizationOutput:
    recording: str
    labels1st: np.ndarray             # [N] 0-based speaker labels
    labels2nd: Optional[np.ndarray]   # [N] second-best labels (if VB ran, S>1)
    n_speakers: int                   # surviving speakers (distinct labels1st)
    n_iters: int                      # VB iterations run (0 if init-only)
    elbo: Optional[np.ndarray]        # ELBO trace (nan-padded) or None
    gamma: Optional[np.ndarray]       # [N, S] final responsibilities or None


def _top2(gamma: torch.Tensor, speaker_mask: torch.Tensor):
    """[B, T, S] responsibilities -> (labels1, labels2) [B, T] int32 on the
    responsibilities' device, so only two small integer planes move to the
    host. Padded speaker lanes are masked to -1 (gamma >= 0), so a frame
    whose valid responsibilities underflow to 0 never selects a padded
    index. Ties break to the LOWEST index, as in vbx_tpu (lax.top_k):
    torch.argmax returns the first maximal index, and the second label is
    the argmax after masking the first (torch.topk promises no order among
    ties)."""
    S = gamma.shape[-1]
    neg = torch.full((), -1.0, dtype=gamma.dtype, device=gamma.device)
    masked = torch.where(speaker_mask[:, None, :], gamma, neg)
    l1 = masked.argmax(-1)
    if S == 1:
        return l1.to(torch.int32), l1.to(torch.int32)
    l2 = masked.scatter(-1, l1[..., None], -2.0).argmax(-1)
    return l1.to(torch.int32), l2.to(torch.int32)


def resolve_fb_impl(fb_impl: Optional[str], config: DiarizationConfig,
                    device: torch.device) -> Optional[str]:
    """Effective forward-backward engine: an explicit argument (CLI
    --fb-impl) always wins; otherwise the preset's engine of record
    (VBConfig.fb_impl — the corpus presets select 'pallas_bf16', the fused
    CUDA kernel route with bfloat16 streams). A preset's 'pallas*'
    selection resolves back to the structured engine when the device is
    the CPU, as vbx_tpu does on JAX's CPU backend: the kernel's plain twin
    is a reference, not a fast path."""
    if fb_impl is not None:
        return fb_impl
    pick = config.vb.fb_impl
    if pick and pick.startswith("pallas") and device.type == "cpu":
        return None
    return pick


def effective_vb_stop(config: DiarizationConfig,
                      fb_impl: Optional[str]) -> Tuple[float, float, int]:
    """(epsilon, plateau_ulps, plateau_iters) for the RESOLVED engine.

    The bf16-stream engine's stop rules fire on its own stream noise at
    corpus scale, truncating the EM far from the fixed point
    (VBConfig.bf16_run_to_max); with the flag set, a resolved 'pallas_bf16'
    runs max_iters with both rules disabled. Every other engine keeps the
    configured rules."""
    vb = config.vb
    if fb_impl == "pallas_bf16" and vb.bf16_run_to_max:
        return float("-inf"), 0.0, vb.plateau_iters
    return vb.epsilon, vb.plateau_ulps, vb.plateau_iters


def run_vb_chunk(diar: "Diarizer", x_rows: List[torch.Tensor],
                 g_rows: List[torch.Tensor], shapes: List[Tuple[int, int]],
                 t_pad: int, s_pad: int, fb_impl: Optional[str],
                 mesh: Optional[Mesh] = None):
    """Run one VB chunk: B recordings' device rows padded to one bucket
    (`x_rows` [t_pad, D] features, `g_rows` [t_pad, s_pad] qinit, as
    Diarizer.bucket_planes makes them) and their true (T, S) `shapes` ->
    (labels1, labels2, result) on the device: top-2 labels [B', t_pad]
    int32 and the engine's result (gamma, n_iters, elbo), lane b < B
    recording b. The row lists are emptied once stacked, so rows whose only
    other holder was the caller are freed before the EM.

    Priors are uniform over each recording's S speakers; frame and speaker
    masks mark its (T, S) corner. The stop rule is the engine's
    (effective_vb_stop). Under a `mesh` the chunk runs through
    parallel.vbx_sharded with `fb_impl` as its engine, its lanes padded to
    a multiple of 'dp' with REPLICAS of lane 0 (B' >= B; results
    discarded: an all-masked lane would put zero counts through the M-step
    divisions, and a replica converges in lockstep with lane 0, so padding
    adds no EM iterations). The labels are taken on the device (_top2), so
    a fetch moves two small integer planes, not gamma."""
    cfg = diar.config
    dev = diar.device
    B = len(x_rows)
    lanes = list(range(B))
    if mesh is not None:
        lanes += [0] * (round_up(B, mesh.shape["dp"]) - B)
    X = torch.stack([x_rows[b] for b in lanes])
    G = torch.stack([g_rows[b] for b in lanes])
    del x_rows[:], g_rows[:]
    PI = np.zeros((len(lanes), s_pad), dtype=diar._np_dtype)
    FM = np.zeros((len(lanes), t_pad), dtype=bool)
    SM = np.zeros((len(lanes), s_pad), dtype=bool)
    for lane, b in enumerate(lanes):
        T, S = shapes[b]
        PI[lane, :S] = 1.0 / S
        FM[lane, :T] = True
        SM[lane, :S] = True
    eps, p_ulps, p_iters = effective_vb_stop(cfg, fb_impl)
    kw = dict(loop_prob=cfg.vb.loop_prob, Fa=cfg.vb.Fa, Fb=cfg.vb.Fb,
              max_iters=cfg.vb.max_iters, epsilon=eps, fb_impl=fb_impl,
              plateau_ulps=p_ulps, plateau_iters=p_iters)
    phi = diar._put(diar.plda_psi[:cfg.lda_dim])
    if mesh is None:
        res = vbx_batched(X, phi, G, diar._put(PI),
                          torch.as_tensor(FM, device=dev),
                          torch.as_tensor(SM, device=dev), device=dev, **kw)
    else:
        # imported here: parallel.engine imports the engine package, which
        # imports this module
        from vbx_tpu_torch.parallel.engine import vbx_sharded
        res = vbx_sharded(mesh, X, phi, G, diar._put(PI), FM, SM, **kw)
    l1, l2 = _top2(res.gamma, torch.as_tensor(SM, device=res.gamma.device))
    return l1, l2, res


def _parse_init(init: str) -> Tuple[str, Optional[int], bool]:
    """-> (kind, n_random_speakers, run_vb). Accepts 'AHC', 'AHC+VB',
    'random_<N>', 'random_<N>+VB'."""
    run_vb = init.endswith("VB")
    base = init[:-3] if run_vb else init
    if base == "AHC":
        return "AHC", None, run_vb
    if base.startswith("random_"):
        return "random", int(base.split("_", 1)[1]), run_vb
    raise ValueError(f"unsupported init {init!r} (use AHC, AHC+VB, "
                     "random_<N>, random_<N>+VB)")


class Diarizer:
    """Holds the (tiny, host-prepped) models; reusable across recordings.

    `plda` is the Kaldi model (mu, tr, psi) and `transform` the x-vector
    transform (mean1, lda, mean2), both as numpy arrays: the same tuples
    vbx_tpu's Diarizer takes, so one set of parameters builds both.
    `device` runs the VB engine ('cuda' unless the caller passes 'cpu')."""

    def __init__(self, config: DiarizationConfig,
                 plda: Tuple[np.ndarray, np.ndarray, np.ndarray],
                 transform: Tuple[np.ndarray, np.ndarray, np.ndarray],
                 dtype=None, device: DeviceLike = None):
        self.config = config
        self.device = resolve_device(device)

        def own(a):
            # fresh, C-ordered, allocator-aligned f64 copies: h5py (and
            # eigh-output) buffers can be unaligned or non-contiguous,
            # which drops NumPy's dgemm onto a strided fallback
            return np.array(a, dtype=np.float64, order="C", copy=True)

        # one-time 128x128 host-side re-diagonalization (vbhmm.py:109-113)
        self.plda_mu, self.plda_tr, self.plda_psi = map(
            own, rediagonalize_plda(*plda))
        self.raw_plda = plda
        self.mean1, self.lda, self.mean2 = map(own, transform)
        self.dtype = torch_dtype(dtype or config.vb.dtype)
        self._np_dtype = torch.empty((), dtype=self.dtype).numpy().dtype
        # vb_inputs projection, precomputed owned-contiguous
        self._vb_tr = own(self.plda_tr.T[:, :config.lda_dim])

    @classmethod
    def from_files(cls, config: DiarizationConfig, plda_file: str,
                   transform_file: str, dtype=None,
                   device: DeviceLike = None) -> "Diarizer":
        return cls(config, read_plda(plda_file),
                   read_xvec_transform(transform_file), dtype=dtype,
                   device=device)

    # -- per-recording stages ------------------------------------------------

    def transform_xvectors(self, x_raw: np.ndarray) -> np.ndarray:
        """Raw embeddings (N, 256) -> PLDA-space unit vectors (N, 128)
        (vbhmm.py:125-129), in float64 on the host: they feed the AHC init
        chain, whose calibration threshold and linkage cut are sensitive
        below f32 resolution. The VB engine receives them cast to the engine
        dtype."""
        x = np.asarray(x_raw, dtype=np.float64)
        y = x - self.mean1
        y /= np.sqrt((y * y).sum(axis=1, keepdims=True))
        y = y @ self.lda - self.mean2
        y /= np.sqrt((y * y).sum(axis=1, keepdims=True))
        return y

    def initial_labels(self, x: np.ndarray, seed: int = 0,
                       precomputed_Z: Optional[np.ndarray] = None,
                       precomputed_thr: Optional[float] = None
                       ) -> np.ndarray:
        """Initial speaker labels: AHC (on this Diarizer's device where the
        AHC routes use one, engine.ahc) or random_<K>. precomputed_Z /
        precomputed_thr carry the corpus pre-stage's batched walk and
        calibration."""
        kind, n_rand, _ = _parse_init(self.config.init)
        ahc_cfg = self.config.ahc
        if kind == "AHC":
            if 0 < ahc_cfg.fallback_n < len(x):
                # preset-level long-recording fallback: the O(N^2) AHC
                # front half is skipped for random_<K>+VB, the reference
                # README's own advice for such files (README.md:24)
                print(f"AHC fallback: N={len(x)} > {ahc_cfg.fallback_n}, "
                      f"using random_{ahc_cfg.fallback_speakers} init",
                      file=sys.stderr)
                return random_labels(len(x), ahc_cfg.fallback_speakers,
                                     seed=seed)
            return ahc_labels(
                x, ahc_cfg.threshold,
                similarity=ahc_cfg.similarity,
                plda=self.raw_plda,
                target_energy=ahc_cfg.target_energy,
                compute_backend=ahc_cfg.compute_backend,
                precomputed_Z=precomputed_Z,
                precomputed_thr=precomputed_thr,
                device=self.device)
        return random_labels(len(x), n_rand, seed=seed)

    def vb_inputs(self, x: np.ndarray, labels: np.ndarray):
        """(features, phi, qinit) for the VB stage (vbhmm.py:150-153)."""
        cfg = self.config
        qinit = smooth_labels_to_gamma(labels, cfg.ahc.init_smoothing)
        fea = (x - self.plda_mu) @ self._vb_tr
        phi = self.plda_psi[:cfg.lda_dim]
        return fea, phi, qinit

    def bucket_planes(self, x: np.ndarray, labels: np.ndarray):
        """One recording's VB planes padded to its (T, S) bucket
        (utils.bucketing.bucket_shape), from its transformed x-vectors and
        init labels -> (T, S, (t_pad, s_pad), Xi [t_pad, D], Gi [t_pad,
        s_pad]): host arrays in the engine dtype, zero past (T, S). The
        caller uploads them and runs them through run_vb_chunk."""
        fea, _, qinit = self.vb_inputs(x, labels)
        T, S = qinit.shape
        key = bucket_shape(T, S)
        Xi = np.zeros((key[0], fea.shape[1]), dtype=self._np_dtype)
        Gi = np.zeros(key, dtype=self._np_dtype)
        Xi[:T] = fea
        Gi[:T, :S] = qinit
        return T, S, key, Xi, Gi

    def _put(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, self._np_dtype),
                               device=self.device)

    def diarize_xvectors(self, x_raw: np.ndarray, seed: int = 0,
                         keep_gamma: bool = False,
                         fb_impl: Optional[str] = None) -> DiarizationOutput:
        """Full single-recording path (streaming mode). fb_impl follows
        vbx_batched's choices; the batched-only kernel routes run as a B=1
        batch so a one-recording run still exercises the requested
        engine."""
        cfg = self.config
        fb_impl = resolve_fb_impl(fb_impl, cfg, self.device)
        _, _, run_vb = _parse_init(cfg.init)
        x = self.transform_xvectors(x_raw)
        labels1st = self.initial_labels(x, seed=seed)
        labels2nd = None
        n_iters = 0
        elbo = None
        gamma_out = None

        if run_vb:
            fea, phi, qinit = self.vb_inputs(x, labels1st)
            T, S = qinit.shape
            if fb_impl is not None and fb_impl.startswith("pallas"):
                # the batched chunk path at B = 1, unpadded
                l1, l2, res = run_vb_chunk(
                    self, [self._put(fea)], [self._put(qinit)], [(T, S)],
                    T, S, fb_impl)
                res = res._replace(gamma=res.gamma[0], elbo=res.elbo[0],
                                   n_iters=res.n_iters[0])
            else:
                res = vbx(
                    self._put(fea), self._put(phi),
                    loop_prob=cfg.vb.loop_prob, Fa=cfg.vb.Fa, Fb=cfg.vb.Fb,
                    pi=torch.full((S,), 1.0 / S, dtype=self.dtype,
                                  device=self.device),
                    gamma=self._put(qinit),
                    max_iters=cfg.vb.max_iters, epsilon=cfg.vb.epsilon,
                    fb_impl=fb_impl or "structured",
                    plateau_ulps=cfg.vb.plateau_ulps,
                    plateau_iters=cfg.vb.plateau_iters, device=self.device)
                # the same on-device top-2 as the batched path, so a
                # recording's labels are method-identical across routes
                l1, l2 = _top2(res.gamma[None],
                               torch.ones((1, S), dtype=torch.bool,
                                          device=self.device))
            labels1st = l1[0].cpu().numpy()
            if S > 1:
                labels2nd = l2[0].cpu().numpy()
            n_iters = int(res.n_iters)
            elbo = res.elbo.cpu().numpy()
            if keep_gamma:
                gamma_out = res.gamma.cpu().numpy()

        return DiarizationOutput(
            recording="", labels1st=labels1st, labels2nd=labels2nd,
            n_speakers=len(np.unique(labels1st)), n_iters=n_iters,
            elbo=elbo, gamma=gamma_out)


def diarize_xvectors(x_raw: np.ndarray, config: DiarizationConfig,
                     plda, transform, device: DeviceLike = None,
                     **kw) -> DiarizationOutput:
    """One recording's raw x-vectors -> labels, through a Diarizer built for
    this call (`device` as Diarizer's; `kw` as its diarize_xvectors)."""
    return Diarizer(config, plda, transform,
                    device=device).diarize_xvectors(x_raw, **kw)


def diarize_ark(
    ark_file: str,
    segments_file: str,
    out_rttm_dir: str,
    config: DiarizationConfig,
    plda_file: str,
    transform_file: str,
    batch: bool = True,
    max_batch_frames: int = 2_000_000,
    verbose: bool = True,
    resume: bool = False,
    runlog_path: Optional[str] = None,
    shard_over_hosts: bool = False,
    fb_impl: Optional[str] = None,
    failures: Optional[Dict[str, str]] = None,
    device: DeviceLike = None,
    mesh: Optional[Mesh] = None,
) -> Dict[str, DiarizationOutput]:
    """Diarize every recording in an ark file and write per-recording RTTMs
    (CLI parity: vbhmm.py:115-179). `batch=True` pads recordings into
    (T, S)-buckets and runs the batched engine.

    `resume=True` skips recordings whose RTTM already exists. `runlog_path`
    appends one JSON record per recording plus a summary.

    `shard_over_hosts=True`: this process diarizes only its contiguous
    slice of the ark's recordings (parallel.distributed: corpus
    data-parallelism over the processes of a multi-host run). The
    per-recording RTTMs are the durable outputs, so nothing is gathered
    beyond their concatenation by process 0.

    Failure isolation: a recording whose init or VB raises is skipped with a
    warning (recorded in `failures` if a dict is passed, and in the runlog)
    unless the caller asked for exactly one recording — that run fails
    visibly. If EVERY recording fails, a RuntimeError is raised.

    `device`: 'cuda' unless the caller passes 'cpu'.

    `mesh`: a ('dp', 'sp') parallel.Mesh routes every VB bucket through
    the sharded engine (parallel.vbx_sharded): recordings data-parallel
    over 'dp', frames sequence-parallel over 'sp'. A mesh is one process's:
    with more than one process in the run it raises ValueError. This is the
    long-recording path the reference lacks (its forward-backward is a
    strict T-step loop, VBx/VBx.py:167-171, and its README.md:24 calls
    files over 30 minutes its weakness). Under a mesh, single recordings
    run as a dp-padded batch of one. fb_impl=None/'structured' uses the
    plain-torch blockwise smoother; 'pallas'/'pallas_bf16' run the K2 + K1
    kernels on every shard; anything else, and batch=False, is overridden
    with a warning.
    """
    from vbx_tpu_torch.utils.runlog import RunLog

    dev = resolve_device(device)
    fb_impl = resolve_fb_impl(fb_impl, config, dev)
    # the pass's span record: host seconds by runlog key, written once
    spans: Dict[str, float] = {}
    reads0 = read_counters()
    with annotate("vbx.entry.read", spans, "read_s"):
        diar = Diarizer.from_files(config, plda_file, transform_file,
                                   device=dev)
        segs_dict = read_xvector_timing_dict(segments_file)
        t_start = time.perf_counter()
        recs: List[Tuple[str, List[str], np.ndarray]] = list(
            read_vec_ark_grouped(ark_file))
    reads = read_counters(since=reads0)
    os.makedirs(out_rttm_dir, exist_ok=True)
    runlog = RunLog(runlog_path)
    if shard_over_hosts:
        recs = recs[distributed.local_recording_slice(len(recs))]
    # strictness follows the caller's REQUEST, not what remains after the
    # resume filter: a corrupt recording must stay skippable on re-runs
    strict = len(recs) == 1
    n_resumed = 0
    if resume:
        skipped = {r for r, _, _ in recs if os.path.exists(
            os.path.join(out_rttm_dir, f"{r}.rttm"))}
        recs = [it for it in recs if it[0] not in skipped]
        n_resumed = len(skipped)
        if skipped and verbose:
            print(f"resume: skipping {len(skipped)} finished recording(s)")
    if not recs:
        runlog.close()
        return {}
    if failures is None:
        failures = {}

    outputs: Dict[str, DiarizationOutput] = {}
    # the batched path's stage record (the runlog's `stages` event)
    stage_log: Optional[Dict[str, object]] = None
    try:
        _, _, run_vb = _parse_init(config.init)
        if mesh is not None and run_vb:
            if distributed.process_count() > 1:
                # every process would drive its own mesh over its own
                # slice; a per-process mesh is not wired (vbx_tpu's rule)
                raise ValueError(
                    "mesh routing is single-process: with "
                    "process_count() > 1 use shard_over_hosts for "
                    "the recording axis (a per-host ('dp','sp') mesh "
                    "over the local devices is not yet wired)")
            check_sp_divides_buckets(mesh)
            mesh_fb = (fb_impl if fb_impl in ("structured", "pallas",
                                              "pallas_bf16") else None)
            if not batch or (fb_impl is not None and mesh_fb is None):
                # a mesh implies the sharded batched engine: say so rather
                # than silently ignoring the arguments
                warnings.warn(
                    "mesh routing overrides "
                    + ("batch=False" if not batch else f"fb_impl="
                       f"{fb_impl!r}")
                    + ": the sharded engine is batched and supports "
                      "fb_impl in ('structured', 'pallas', "
                      "'pallas_bf16')", stacklevel=2)
        if not run_vb or (mesh is None and (not batch or len(recs) == 1)):
            for rec, seg_names, x_raw in recs:
                if verbose:
                    print(rec)
                try:
                    out = diar.diarize_xvectors(x_raw, fb_impl=fb_impl)
                except Exception as exc:   # noqa: BLE001 — isolate per rec
                    _warn_failed(rec, exc, runlog, failures, strict=strict)
                    continue
                out.recording = rec
                outputs[rec] = out
        else:
            from vbx_tpu_torch.clustering import device as cdev

            stage_log = {"read": reads}
            walks0 = cdev.walk_counters()
            outputs = _diarize_batched(diar, recs, max_batch_frames, verbose,
                                       fb_impl=fb_impl, stage_log=stage_log,
                                       runlog=runlog, failures=failures,
                                       mesh=mesh)
            # the pass's deltas: a long-lived process walks for its whole
            # life
            stage_log["walk"] = cdev.walk_counters(since=walks0)

        if not outputs and not n_resumed:
            # nothing succeeded now or in a previous (resumed) run: an
            # all-broken corpus must not masquerade as empty-but-successful
            raise RuntimeError(
                f"all {len(recs)} recording(s) failed: "
                f"{dict(list(failures.items())[:3])}")

        with annotate("vbx.entry.write", spans, "write_s"):
            for rec, seg_names, x_raw in recs:
                if rec not in outputs:
                    continue               # failed recording, already warned
                names, times = segs_dict[rec]
                if not np.all(names == np.array(seg_names)):
                    raise ValueError(f"segments/ark name mismatch for {rec}")
                out = outputs[rec]
                start, end = times.T
                starts, ends, out_labels = merge_adjacent_labels(
                    start, end, out.labels1st)
                write_rttm(os.path.join(out_rttm_dir, f"{rec}.rttm"),
                           rec, starts, ends, out_labels)
                if config.output_2nd and out.labels2nd is not None:
                    starts2, ends2, labels2 = merge_adjacent_labels(
                        start, end, out.labels2nd)
                    dir2 = f"{out_rttm_dir}2nd"
                    os.makedirs(dir2, exist_ok=True)
                    write_rttm(os.path.join(dir2, f"{rec}.rttm"),
                               rec, starts2, ends2, labels2)
                runlog.recording(rec, n_speakers=out.n_speakers,
                                 n_iters=out.n_iters, elbo=out.elbo)
        if stage_log is not None:
            runlog.write({"event": "stages", **stage_log,
                          **{k: round(v, 3) for k, v in spans.items()}})
        runlog.write({"event": "summary", "n_recordings": len(recs),
                      "n_failed": len(failures),
                      "failed": sorted(failures) or None,
                      "seconds": round(time.perf_counter() - t_start, 3),
                      "config": config.name, "init": config.init})
    finally:
        runlog.close()
    return outputs


def _warn_failed(rec: str, exc: Exception, runlog=None,
                 failures: Optional[Dict[str, str]] = None,
                 strict: bool = False) -> None:
    """Per-recording failure isolation (reference parity: one bad file
    kills only its own task line, AMI_run.sh:53-58). strict=True re-raises
    — a single-recording run should fail visibly."""
    if strict:
        raise exc
    print(f"ERROR: recording {rec!r} failed and is skipped: "
          f"{type(exc).__name__}: {exc}", file=sys.stderr)
    if failures is not None:
        failures[rec] = f"{type(exc).__name__}: {exc}"
    if runlog is not None:
        runlog.write({"event": "recording_failed", "recording": rec,
                      "error": f"{type(exc).__name__}: {exc}"})


def _pre_stage(diar: Diarizer, recs) -> Dict[int, tuple]:
    """The corpus pre-stage: {recording index: (f64 transformed x, Z,
    threshold)} for the recordings whose AHC the 'auto' route would send to
    the card's walk (AHC init, cosine, 'auto', a CUDA device, N >=
    _DEVICE_LINKAGE_MIN_N, not over fallback_n), when there are at least
    two. Their walks and calibration sweeps run batched: size-aware groups,
    each within 2x of its smallest recording, one walk launch and one
    batched sweep a group. The labels are the per-recording route's (the
    cut stays per recording). When a group's walk trips the reducibility
    guard, every recording not linked yet keeps its transform with Z None
    and takes the per-recording route; any other failure propagates."""
    from concurrent.futures import ThreadPoolExecutor

    from vbx_tpu_torch.clustering import device as cdev
    from vbx_tpu_torch.engine import ahc
    from vbx_tpu_torch.ops.calibration import (
        two_gmm_calib_cosine_device_batched)

    cfg = diar.config
    kind, _, _ = _parse_init(cfg.init)
    if not (kind == "AHC" and cfg.ahc.similarity == "cosine"
            and cfg.ahc.compute_backend == "auto"
            and ahc._on_cuda(diar.device)):
        return {}
    elig = [i for i in range(len(recs))
            if len(recs[i][2]) >= ahc._DEVICE_LINKAGE_MIN_N
            and not (0 < cfg.ahc.fallback_n < len(recs[i][2]))]
    if len(elig) < 2:
        return {}
    xs: Dict[int, np.ndarray] = {}
    with annotate("vbx.pre.transform"), ThreadPoolExecutor(
            max_workers=min(8, len(elig))) as pool:
        for i, fut in [(i, pool.submit(diar.transform_xvectors, recs[i][2]))
                       for i in elig]:
            try:
                xs[i] = fut.result()
            except Exception:   # noqa: BLE001 — prep() re-runs and
                pass            # isolates the failure
    # a batched walk runs every lane to the group's longest, so one hour
    # must not hold up a dozen 8k-meeting lanes: greedy groups within 2x
    order = sorted(xs, key=lambda i: len(xs[i]))
    groups: List[List[int]] = []
    for i in order:
        if groups and len(xs[i]) <= 2 * len(xs[groups[-1][0]]):
            groups[-1].append(i)
        else:
            groups.append([i])
    pre: Dict[int, tuple] = {}
    try:
        for grp in groups:
            xns = [np.ascontiguousarray(ahc._normalized(xs[i])) for i in grp]
            Zs = cdev.linkage_dot_avg_device_batched(xns, device=diar.device)
            with annotate("vbx.pre.calibrate"):
                thrs = two_gmm_calib_cosine_device_batched(
                    xns, device=diar.device)
            pre.update({i: (xs[i], Z, float(t))
                        for i, Z, t in zip(grp, Zs, thrs)})
    except cdev.ReducibilityError as exc:
        warnings.warn(
            f"batched device linkage failed ({exc!r}); recordings fall "
            f"back to the per-recording init path", stacklevel=3)
        # keep the float64 transforms: prep() runs the per-recording AHC
        # on them (recordings already linked keep their Z)
        for i, x in xs.items():
            pre.setdefault(i, (x, None, None))
    return pre


def _diarize_batched(diar: Diarizer, recs, max_batch_frames: int,
                     verbose: bool, init_workers: int = 8,
                     fb_impl: Optional[str] = None,
                     stage_log: Optional[Dict[str, object]] = None,
                     runlog=None,
                     failures: Optional[Dict[str, str]] = None,
                     mesh: Optional[Mesh] = None,
                     ) -> Dict[str, DiarizationOutput]:
    """Bucketed-padded batched VB over all recordings, pipelined against the
    host init chain. The init chain (f64 transform + similarity +
    calibration + native linkage) runs across a thread pool — BLAS and the
    ctypes linkage release the GIL. As recordings finish initializing,
    (T, S)-bucket chunks are launched in doubling sizes (B = 1, 2, 4, ...
    up to the frame-budget cap), so the device works while the remaining
    recordings initialize; each chunk's top-2 label planes come back to the
    host as soon as it finishes. Chunk composition depends on init
    completion order, which is fine: a recording's result does not depend
    on its batch (bit-equal on the structured engine, tolerance-bounded on
    the kernel route — tests/test_torch_vbhmm.py).

    `stage_log`, if given, is filled with wall-clock stage timings: init_s
    (pool wall), vb_s (VB work left after init finished),
    vb_chunks_overlapped (chunks launched while init was running), and
    per-bucket shapes.

    `mesh` sends each chunk through parallel.vbx_sharded (run_vb_chunk),
    with max_batch_frames the budget of each of its devices (chunk_cap)."""
    from concurrent.futures import ThreadPoolExecutor, as_completed

    from vbx_tpu_torch.utils.hostblas import host_pools, single_thread_blas

    dev = diar.device
    n = len(recs)
    # a mesh runs the kernel engines or its own structured smoother (None)
    vb_fb = (fb_impl if mesh is None or fb_impl in ("pallas", "pallas_bf16")
             else None)

    spans: Dict[str, float] = {}      # host seconds by runlog key
    with annotate("vbx.pre", spans, "pre_linkage_s"):
        pre_xz = _pre_stage(diar, recs)
    if stage_log is not None and pre_xz:
        stage_log["pre_linkage_s"] = round(spans["pre_linkage_s"], 3)
        stage_log["pre_linkage_recordings"] = sum(
            1 for v in pre_xz.values() if v[1] is not None)

    def prep(i):
        rec, _, x_raw = recs[i]
        pre = pre_xz.pop(i, None)
        if pre is not None:
            x, Z_pre, thr_pre = pre
            labels = diar.initial_labels(x, precomputed_Z=Z_pre,
                                         precomputed_thr=thr_pre)
        else:
            x = diar.transform_xvectors(x_raw)
            labels = diar.initial_labels(x)
        planes = diar.bucket_planes(x, labels)
        if verbose:
            print(rec)
        return i, planes

    prepped: List[Optional[tuple]] = [None] * n   # (rec, T, S)
    x_dev: Dict[int, torch.Tensor] = {}           # uploaded planes by index
    g_dev: Dict[int, torch.Tensor] = {}
    pending: Dict[Tuple[int, int], List[int]] = {}
    next_chunk: Dict[Tuple[int, int], int] = {}   # doubling launch size/key
    done: List[dict] = []

    def launch(idxs: List[int], T_pad: int, S_pad: int) -> None:
        with annotate("vbx.vb.chunk"):
            l1, l2, res = run_vb_chunk(
                diar, [x_dev.pop(i) for i in idxs],
                [g_dev.pop(i) for i in idxs],
                [prepped[i][1:] for i in idxs], T_pad, S_pad, vb_fb, mesh)
            done.append({"idxs": idxs, "T_pad": T_pad, "S_pad": S_pad,
                         "l1": l1.cpu().numpy(), "l2": l2.cpu().numpy(),
                         "iters": res.n_iters.cpu().numpy(),
                         "elbos": res.elbo.cpu().numpy()})

    # parallelism across recordings, not within: pool workers x per-call
    # OpenMP teams oversubscribe the host, so the native linkage runs
    # single-threaded inside the pool (restored after)
    n_workers = min(init_workers, n, os.cpu_count() or init_workers)
    n_overlapped = 0
    with annotate("vbx.init", spans, "init_s"), (
            host_pools(1) if n_workers > 1 else single_thread_blas()), \
            ThreadPoolExecutor(max_workers=n_workers) as pool:
        futures = {pool.submit(prep, i): i for i in range(n)}
        for fut in as_completed(futures):
            try:
                i, (T, S, key, Xi, Gi) = fut.result()
            except Exception as exc:   # noqa: BLE001 — per rec
                _warn_failed(recs[futures[fut]][0], exc, runlog, failures)
                continue
            # upload from the main thread so the copy overlaps the pool's
            # remaining init work
            prepped[i] = (recs[i][0], T, S)
            x_dev[i] = torch.as_tensor(Xi, device=dev)
            g_dev[i] = torch.as_tensor(Gi, device=dev)
            pending.setdefault(key, []).append(i)
            per_batch = chunk_cap(key[0], max_batch_frames, mesh)
            want = min(next_chunk.get(key, 1), per_batch)
            if len(pending[key]) >= want:
                # launch now, under the remaining init; double the next
                # chunk so batch shapes stay few
                launch(pending.pop(key), *key)
                next_chunk[key] = min(max(2 * want, 2), per_batch)
                n_overlapped += 1
    if stage_log is not None:
        stage_log["init_s"] = round(spans["init_s"], 3)
        stage_log["vb_chunks_overlapped"] = n_overlapped
        stage_log["buckets"] = []

    outputs: Dict[str, DiarizationOutput] = {}
    with annotate("vbx.vb.tail", spans, "vb_s"):
        for (T_pad, S_pad), idxs in sorted(pending.items()):
            launch(idxs, T_pad, S_pad)
        for entry in done:
            idxs = entry["idxs"]
            if stage_log is not None:
                stage_log["buckets"].append(
                    {"B": len(idxs), "T_pad": entry["T_pad"],
                     "S_pad": entry["S_pad"],
                     "max_iters_run": int(entry["iters"].max())})
            for bi, i in enumerate(idxs):
                rec, T, S = prepped[i]
                l1 = entry["l1"][bi, :T]
                outputs[rec] = DiarizationOutput(
                    recording=rec, labels1st=l1,
                    labels2nd=(entry["l2"][bi, :T] if S > 1 else None),
                    n_speakers=len(np.unique(l1)),
                    n_iters=int(entry["iters"][bi]),
                    elbo=entry["elbos"][bi], gamma=None)
    if stage_log is not None:
        stage_log["vb_s"] = round(spans["vb_s"], 3)
    return outputs
