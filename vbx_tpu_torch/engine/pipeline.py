"""End-to-end diarization pipeline: transformed x-vectors -> initialization
-> VB-HMM -> merged RTTM segments (port of vbx_tpu.engine.pipeline).

Orchestration parity with the reference diarization CLI (vbhmm.py:54-179).
Recordings run one by one (streaming) or padded and batched
(`diarize_ark(..., batch=True)`), where the batched path buckets recordings
by (T, S), runs the host init chain across a thread pool and launches each
bucket's chunks through the batched engine as they fill.

`diarize_ark(mesh=...)` routes every VB bucket through the sharded engine
(parallel.vbx_sharded): recordings over the mesh's 'dp' rows, the frames of
each recording over its 'sp' shards.

Not ported yet: `shard_over_hosts`, and the corpus pre-stage that batches
mid-N recordings' NN-chain walks and calibrations on the accelerator
(vbx_tpu/engine/pipeline.py:508-599). Those recordings run the float64
host init chain here, which gives the same labels (engine.ahc).
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
from vbx_tpu_torch.io.ark import group_by_recording, iter_vec_ark
from vbx_tpu_torch.io.plda import read_plda, rediagonalize_plda
from vbx_tpu_torch.io.rttm import merge_adjacent_labels, write_rttm
from vbx_tpu_torch.io.segments import read_xvector_timing_dict
from vbx_tpu_torch.io.transform import read_xvec_transform
from vbx_tpu_torch.parallel.engine import vbx_sharded
from vbx_tpu_torch.parallel.mesh import Mesh
from vbx_tpu_torch.utils.bucketing import T_QUANTUM


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

    def initial_labels(self, x: np.ndarray, seed: int = 0) -> np.ndarray:
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
                compute_backend=ahc_cfg.compute_backend)
        return random_labels(len(x), n_rand, seed=seed)

    def vb_inputs(self, x: np.ndarray, labels: np.ndarray):
        """(features, phi, qinit) for the VB stage (vbhmm.py:150-153)."""
        cfg = self.config
        qinit = smooth_labels_to_gamma(labels, cfg.ahc.init_smoothing)
        fea = (x - self.plda_mu) @ self._vb_tr
        phi = self.plda_psi[:cfg.lda_dim]
        return fea, phi, qinit

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
                eps_eff, pu_eff, pi_eff = effective_vb_stop(cfg, fb_impl)
                res = vbx_batched(
                    self._put(fea)[None], self._put(phi),
                    self._put(qinit)[None],
                    torch.full((1, S), 1.0 / S, dtype=self.dtype,
                               device=self.device),
                    torch.ones((1, T), dtype=torch.bool, device=self.device),
                    torch.ones((1, S), dtype=torch.bool, device=self.device),
                    loop_prob=cfg.vb.loop_prob, Fa=cfg.vb.Fa, Fb=cfg.vb.Fb,
                    max_iters=cfg.vb.max_iters, epsilon=eps_eff,
                    fb_impl=fb_impl, plateau_ulps=pu_eff,
                    plateau_iters=pi_eff, device=self.device)
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
            # the same on-device top-2 as the batched path, so a recording's
            # labels are method-identical across routes
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

    Failure isolation: a recording whose init or VB raises is skipped with a
    warning (recorded in `failures` if a dict is passed, and in the runlog)
    unless the caller asked for exactly one recording — that run fails
    visibly. If EVERY recording fails, a RuntimeError is raised.

    `device`: 'cuda' unless the caller passes 'cpu'.

    `mesh`: a ('dp', 'sp') parallel.Mesh routes every VB bucket through
    the sharded engine (parallel.vbx_sharded): recordings data-parallel
    over 'dp', frames sequence-parallel over 'sp'. This is the
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
    diar = Diarizer.from_files(config, plda_file, transform_file, device=dev)
    segs_dict = read_xvector_timing_dict(segments_file)
    os.makedirs(out_rttm_dir, exist_ok=True)
    runlog = RunLog(runlog_path)
    t_start = time.perf_counter()

    recs: List[Tuple[str, List[str], np.ndarray]] = list(
        group_by_recording(iter_vec_ark(ark_file)))
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
    try:
        _, _, run_vb = _parse_init(config.init)
        if mesh is not None and run_vb:
            n_sp = mesh.shape["sp"]
            if T_QUANTUM % n_sp:
                raise ValueError(
                    f"mesh 'sp' extent {n_sp} must divide the smallest "
                    f"frame bucket ({T_QUANTUM})")
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
            stage_log: Dict[str, object] = {}
            outputs = _diarize_batched(diar, recs, max_batch_frames, verbose,
                                       fb_impl=fb_impl, stage_log=stage_log,
                                       runlog=runlog, failures=failures,
                                       mesh=mesh)
            runlog.write({"event": "stages", **stage_log})

        if not outputs and not n_resumed:
            # nothing succeeded now or in a previous (resumed) run: an
            # all-broken corpus must not masquerade as empty-but-successful
            raise RuntimeError(
                f"all {len(recs)} recording(s) failed: "
                f"{dict(list(failures.items())[:3])}")

        for rec, seg_names, x_raw in recs:
            if rec not in outputs:
                continue                   # failed recording, already warned
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

    `mesh` sends each chunk through parallel.vbx_sharded, padded to a
    multiple of the 'dp' extent with replicas of its first recording;
    max_batch_frames is then a per-device budget."""
    from concurrent.futures import ThreadPoolExecutor, as_completed

    from vbx_tpu_torch.clustering import set_native_threads
    from vbx_tpu_torch.utils.bucketing import bucket_shape, chunk_cap

    cfg = diar.config
    dev = diar.device
    n = len(recs)

    def prep(i):
        rec, _, x_raw = recs[i]
        x = diar.transform_xvectors(x_raw)
        labels = diar.initial_labels(x)
        fea, phi, qinit = diar.vb_inputs(x, labels)
        T, S = qinit.shape
        key = bucket_shape(T, S)
        Xi = np.zeros((key[0], fea.shape[1]), dtype=diar._np_dtype)
        Gi = np.zeros(key, dtype=diar._np_dtype)
        Xi[:T] = fea
        Gi[:T, :S] = qinit
        if verbose:
            print(rec)
        return i, rec, T, S, key, Xi, Gi, phi

    prepped: List[Optional[list]] = [None] * n   # [rec, T, S, X, gamma]
    phi: Optional[np.ndarray] = None
    pending: Dict[Tuple[int, int], List[int]] = {}
    next_chunk: Dict[Tuple[int, int], int] = {}   # doubling launch size/key
    done: List[dict] = []

    def launch(idxs: List[int], T_pad: int, S_pad: int) -> None:
        # under a mesh the sharded engine needs B divisible by the 'dp'
        # extent: pad with REPLICAS of lane 0 (results discarded; an
        # all-masked lane would put zero counts through the M-step
        # divisions, and a replica converges in lockstep with lane 0, so
        # padding adds no EM iterations)
        stack_idxs = idxs
        if mesh is not None:
            n_dp = mesh.shape["dp"]
            stack_idxs = idxs + [idxs[0]] * (-len(idxs) % n_dp)
        B = len(stack_idxs)
        X = torch.stack([prepped[i][3] for i in stack_idxs])
        G = torch.stack([prepped[i][4] for i in stack_idxs])
        PI = np.zeros((B, S_pad), dtype=diar._np_dtype)
        FM = np.zeros((B, T_pad), dtype=bool)
        SM = np.zeros((B, S_pad), dtype=bool)
        for bi, i in enumerate(stack_idxs):
            _, T, S, _, _ = prepped[i]
            PI[bi, :S] = 1.0 / S
            FM[bi, :T] = True
            SM[bi, :S] = True
        for i in idxs:
            prepped[i][3] = prepped[i][4] = None
        kw = dict(loop_prob=cfg.vb.loop_prob, Fa=cfg.vb.Fa, Fb=cfg.vb.Fb,
                  max_iters=cfg.vb.max_iters)
        if mesh is not None:
            mesh_fb = fb_impl if fb_impl in ("pallas", "pallas_bf16") else None
            eps_eff, pu_eff, pi_eff = effective_vb_stop(cfg, mesh_fb)
            res = vbx_sharded(
                mesh, X, diar._put(phi[:cfg.lda_dim]), G, diar._put(PI),
                FM, SM, epsilon=eps_eff, fb_impl=mesh_fb,
                plateau_ulps=pu_eff, plateau_iters=pi_eff, **kw)
        else:
            eps_eff, pu_eff, pi_eff = effective_vb_stop(cfg, fb_impl)
            res = vbx_batched(
                X, diar._put(phi[:cfg.lda_dim]), G, diar._put(PI),
                torch.as_tensor(FM, device=dev), torch.as_tensor(SM,
                                                                 device=dev),
                epsilon=eps_eff, fb_impl=fb_impl, plateau_ulps=pu_eff,
                plateau_iters=pi_eff, device=dev, **kw)
        l1, l2 = _top2(res.gamma, torch.as_tensor(SM,
                                                  device=res.gamma.device))
        done.append({"idxs": idxs, "T_pad": T_pad, "S_pad": S_pad,
                     "l1": l1.cpu().numpy(), "l2": l2.cpu().numpy(),
                     "iters": res.n_iters.cpu().numpy(),
                     "elbos": res.elbo.cpu().numpy()})

    # parallelism across recordings, not within: pool workers x per-call
    # OpenMP teams oversubscribe the host, so the native linkage runs
    # single-threaded inside the pool (restored after)
    n_workers = min(init_workers, n, os.cpu_count() or init_workers)
    t0 = time.perf_counter()
    n_overlapped = 0
    if n_workers > 1:
        set_native_threads(1)
    try:
        import contextlib
        try:
            from threadpoolctl import threadpool_limits
            blas_ctx = threadpool_limits(limits=1, user_api="blas")
        except ImportError:
            blas_ctx = contextlib.nullcontext()
        with blas_ctx, ThreadPoolExecutor(max_workers=n_workers) as pool:
            futures = {pool.submit(prep, i): i for i in range(n)}
            for fut in as_completed(futures):
                try:
                    i, rec, T, S, key, Xi, Gi, p = fut.result()
                except Exception as exc:   # noqa: BLE001 — isolate per rec
                    _warn_failed(recs[futures[fut]][0], exc, runlog,
                                 failures)
                    continue
                # upload from the main thread so the copy overlaps the
                # pool's remaining init work
                prepped[i] = [rec, T, S, torch.as_tensor(Xi, device=dev),
                              torch.as_tensor(Gi, device=dev)]
                if phi is None:
                    phi = p
                pending.setdefault(key, []).append(i)
                per_batch = chunk_cap(key[0], max_batch_frames)
                if mesh is not None:
                    # max_batch_frames is a PER-DEVICE budget and the mesh
                    # splits each chunk's frames over all its devices;
                    # floor to a dp multiple (at least one dp group), since
                    # launch() pads B up to one
                    n_dp = mesh.shape["dp"]
                    per_batch = max(n_dp,
                                    per_batch * mesh.size // n_dp * n_dp)
                want = min(next_chunk.get(key, 1), per_batch)
                if len(pending[key]) >= want:
                    # launch now, under the remaining init; double the next
                    # chunk so batch shapes stay few
                    launch(pending.pop(key), *key)
                    next_chunk[key] = min(max(2 * want, 2), per_batch)
                    n_overlapped += 1
    finally:
        if n_workers > 1:
            set_native_threads(os.cpu_count() or 1)
    if stage_log is not None:
        stage_log["init_s"] = round(time.perf_counter() - t0, 3)
        stage_log["vb_chunks_overlapped"] = n_overlapped
        stage_log["buckets"] = []

    t_vb = time.perf_counter()
    for (T_pad, S_pad), idxs in sorted(pending.items()):
        launch(idxs, T_pad, S_pad)

    outputs: Dict[str, DiarizationOutput] = {}
    for entry in done:
        idxs = entry["idxs"]
        if stage_log is not None:
            stage_log["buckets"].append(
                {"B": len(idxs), "T_pad": entry["T_pad"],
                 "S_pad": entry["S_pad"],
                 "max_iters_run": int(entry["iters"].max())})
        for bi, i in enumerate(idxs):
            rec, T, S, _, _ = prepped[i]
            l1 = entry["l1"][bi, :T]
            outputs[rec] = DiarizationOutput(
                recording=rec, labels1st=l1,
                labels2nd=(entry["l2"][bi, :T] if S > 1 else None),
                n_speakers=len(np.unique(l1)),
                n_iters=int(entry["iters"][bi]), elbo=entry["elbos"][bi],
                gamma=None)
    if stage_log is not None:
        stage_log["vb_s"] = round(time.perf_counter() - t_vb, 3)
    return outputs
