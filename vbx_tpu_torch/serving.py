"""Persistent diarization service with micro-batched device dispatch (port
of vbx_tpu.serving).

The reference has no serving story: each recording is a fresh OS process
(AMI_run.sh:53-58 task lines), so every request pays interpreter and model
load. This module keeps one warm process per card: models stay loaded, the
CUDA kernels stay built, and concurrent requests are MICRO-BATCHED — a
worker thread drains the request queue for a short window, groups requests
into the (T, S) padded buckets of the corpus pipeline (utils.bucketing),
and runs the batched VB engine once per bucket. Every request waits up to
batch_window_ms for batch mates before dispatch (0 for a pure-latency
deployment: batching then only groups requests already queued together).

Results do not depend on batch composition (the structured engine is
bit-equal batched vs solo at a fixed padded shape, the kernel route
within its tolerance — tests/test_torch_vbhmm.py), so batching is
invisible to callers.

Threads and the card:
- submit() starts each request's host init (f64 transform + AHC) on the
  init pool at once. A long request's AHC may take the NN-chain walk on
  the card (engine.ahc 'auto'); clustering.device serializes walks.
- The init pool shares the host's cores: for the service's lifetime each
  worker's BLAS and native linkage teams are capped at cores // workers
  (utils.hostblas.host_pools, released by close()).
- The init thread pads the request's feature and qinit planes to its bucket
  (engine.pipeline.Diarizer.bucket_planes) and uploads them. The upload is
  synchronous (a pageable host tensor's copy returns once its stream has
  finished it), so the planes are on the card before the init future
  resolves, and the dispatch thread, which stacks them only after
  collecting that future, reads finished data on any stream.
- One dispatch thread owns every VB launch, through the corpus pass's one
  chunk path (engine.pipeline.run_vb_chunk: the stack, the masks, the
  'dp' replicas, the engine and its stop rule, and the top-2 labels taken
  on the card, so a chunk's fetch moves two small int32 planes, not
  gamma). utils.bucketing.chunk_cap sizes its chunks, as the corpus
  pass's.

The HTTP front-end lives in cli/serve.py; this module owns no sockets.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import os
import queue
import threading
import time
import warnings
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vbx_tpu_torch.config import DiarizationConfig
from vbx_tpu_torch.device import DeviceLike
from vbx_tpu_torch.engine.pipeline import (
    Diarizer, _parse_init, resolve_fb_impl, run_vb_chunk)
from vbx_tpu_torch.io.rttm import merge_adjacent_labels, write_rttm
from vbx_tpu_torch.parallel.mesh import check_sp_divides_buckets
from vbx_tpu_torch.utils.bucketing import bucket_shape, chunk_cap
from vbx_tpu_torch.utils.hostblas import host_pools


@dataclasses.dataclass
class ServeResult:
    """One diarized request."""
    recording: str
    rttm: str                       # RTTM text (merged segments)
    labels1st: np.ndarray           # [N] 0-based per-x-vector labels
    n_speakers: int
    n_iters: int                    # VB iterations (0 if init-only config)
    wall_ms: float                  # submit -> result wall time
    batch_size: int                 # device batch this request rode in
    labels2nd: Optional[np.ndarray] = None   # config.output_2nd (vbhmm.py:98)
    rttm_2nd: Optional[str] = None


class ServiceOverloaded(RuntimeError):
    """submit() under backlog: the admitted-but-unfinished working set is
    at max_pending_requests. Every admitted VB request pins its padded
    feature/qinit planes in device memory from init time until launch, so
    an unbounded backlog would grow device memory without bound. Callers
    should shed load or retry after results drain."""


class _Request:
    __slots__ = ("recording", "x_raw", "timestamps", "signal", "vad",
                 "future", "init_future", "t_submit",
                 "fea_dev", "qinit_dev", "ts",
                 "labels", "t_init_done", "t_launch", "no_partial",
                 "admitted", "released")

    def __init__(self, recording: str, x_raw: Optional[np.ndarray],
                 timestamps: Optional[np.ndarray],
                 signal: Optional[np.ndarray] = None,
                 vad: Optional[np.ndarray] = None,
                 no_partial: bool = False):
        self.recording = recording
        self.x_raw = x_raw
        self.timestamps = timestamps
        self.signal = signal
        self.vad = vad
        # warmup requests opt out of the partial-launch bound (each wave
        # must ride ONE chunk of the exact padded batch size it warms)
        self.no_partial = no_partial
        self.future: Future = Future()
        self.init_future: Optional[Future] = None
        self.t_submit = time.perf_counter()
        self.labels = None
        self.fea_dev = self.qinit_dev = self.ts = None
        self.t_init_done = self.t_launch = None
        # admission accounting: only submit()-admitted requests count
        self.admitted = False
        self.released = False


_SHUTDOWN = object()


class DiarizationService:
    """Warm, thread-safe diarization service around one device.

    submit() is safe from any thread and returns a Future[ServeResult];
    diarize() is the blocking convenience wrapper. One worker thread owns
    all VB dispatch. `device` is 'cuda' unless the caller passes another
    (vbx_tpu_torch.device.resolve_device); `mesh` (parallel.Mesh) routes
    every bucket through the sharded engine instead."""

    def __init__(self, config: DiarizationConfig, plda, transform, *,
                 extractor=None,
                 fb_impl: Optional[str] = None,
                 mesh=None,
                 batch_window_ms: float = 20.0,
                 max_batch_frames: int = 2_000_000,
                 init_workers: int = 4,
                 runlog_path: Optional[str] = None,
                 max_request_xvectors: int = 200_000,
                 partial_after_ms: float = 50.0,
                 max_pending_requests: int = 256,
                 device: DeviceLike = None):
        self._diar = Diarizer(config, plda, transform, device=device)
        self.device = self._diar.device
        self.extractor = extractor    # engine.extractor.XVectorExtractor
        # audio requests extract one at a time: the extraction fills the
        # card, and interleaved files would only split it
        self._extract_lock = threading.Lock()
        self._fb_impl = resolve_fb_impl(fb_impl, config, self.device)
        if fb_impl is None and self._fb_impl == "pallas_bf16":
            # the corpus presets' bf16 run-to-max engine is a batch-
            # throughput choice (every request runs max_iters with the stop
            # rules disabled); the serving default is the float32 kernel
            # route with the reference's per-request stops. Overridden
            # loudly: the constructor cannot tell a preset default from a
            # deliberate choice; an explicit fb_impl='pallas_bf16' wins.
            warnings.warn(
                "DiarizationService: overriding the config's "
                "fb_impl='pallas_bf16' (a corpus batch-throughput "
                "engine: max_iters per request, stops disabled) with "
                "the serving engine-of-record 'pallas'; pass "
                "fb_impl='pallas_bf16' explicitly to keep it",
                stacklevel=2)
            self._fb_impl = "pallas"
        # a ('dp', 'sp') mesh routes every bucket through the sharded
        # engine (structured smoother, as vbx_tpu's serving)
        self.mesh = mesh
        if mesh is not None:
            check_sp_divides_buckets(mesh)
        self._window_s = batch_window_ms / 1e3
        # head-of-line bound: a bucket group whose oldest member has waited
        # this long launches as a PARTIAL chunk instead of waiting for the
        # cohort's slowest host init. float('inf') waits for the cohort.
        self._partial_after_s = partial_after_ms / 1e3
        self._max_batch_frames = max_batch_frames
        # one oversized request must not exhaust the daemon's memory
        self._max_request_xvectors = max(1, max_request_xvectors)
        # bound the admitted working set (device planes pinned until launch)
        self._max_pending = max(1, max_pending_requests)
        self._pending = 0
        self._queue: "queue.Queue" = queue.Queue()
        self._warmup_lock = threading.Lock()
        init_workers = max(1, init_workers)
        # the native linkage runs an OpenMP team per call and NumPy's dgemm
        # a BLAS team: the init pool's workers share the cores for the
        # service's lifetime (process-global; close() restores both)
        self._pools = contextlib.ExitStack()
        if init_workers > 1:
            self._pools.enter_context(host_pools(
                max(1, (os.cpu_count() or init_workers) // init_workers)))
        self._init_pool = ThreadPoolExecutor(
            max_workers=init_workers, thread_name_prefix="vbx-serve-init")
        from vbx_tpu_torch.utils.runlog import RunLog
        self._runlog = RunLog(runlog_path)   # written by the worker only
        self._lock = threading.Lock()
        self._stats = {"requests": 0, "failed": 0, "batches": 0,
                       "batched_requests": 0, "max_batch": 0}
        self._t_start = time.time()
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="vbx-serve-dispatch")
        self._worker.start()

    @classmethod
    def from_files(cls, config: DiarizationConfig, plda_file: str,
                   transform_file: str, **kw) -> "DiarizationService":
        from vbx_tpu_torch.io.plda import read_plda
        from vbx_tpu_torch.io.transform import read_xvec_transform
        return cls(config, read_plda(plda_file),
                   read_xvec_transform(transform_file), **kw)

    # -- public API ----------------------------------------------------------

    def submit(self, recording: str, x_raw: np.ndarray,
               timestamps: np.ndarray, *, _no_partial: bool = False
               ) -> Future:
        """Enqueue one recording: raw x-vectors [N, D_raw] + per-vector
        (start, end) seconds [N, 2]. Returns a Future[ServeResult]."""
        x_raw = np.asarray(x_raw)
        timestamps = np.asarray(timestamps, np.float64)
        if x_raw.ndim != 2 or timestamps.shape != (len(x_raw), 2):
            raise ValueError(
                f"need x_raw [N, D] and timestamps [N, 2]; got "
                f"{x_raw.shape} and {timestamps.shape}")
        if len(x_raw) == 0:
            raise ValueError("empty request: no x-vectors")
        if len(x_raw) > self._max_request_xvectors:
            raise ValueError(
                f"request {recording!r} has {len(x_raw)} x-vectors > "
                f"max_request_xvectors={self._max_request_xvectors}; "
                f"split the recording or raise the service limit")
        req = _Request(recording, x_raw, timestamps,
                       no_partial=_no_partial)
        self._enqueue(req)
        return req.future

    def diarize(self, recording: str, x_raw: np.ndarray,
                timestamps: np.ndarray,
                timeout: Optional[float] = None) -> ServeResult:
        return self.submit(recording, x_raw, timestamps).result(timeout)

    def submit_audio(self, recording: str, signal: np.ndarray,
                     vad_s: np.ndarray) -> Future:
        """Enqueue raw audio: signal [N] float in [-1, 1) at the
        extractor's sample rate + VAD speech regions [V, 2] (seconds).
        X-vector extraction runs in the service (requires an `extractor`
        at construction); the result diarizes like an x-vector request."""
        if self.extractor is None:
            raise RuntimeError(
                "no extractor configured: pass extractor= (or --weights "
                "to vbx_tpu_torch.cli.serve) to enable audio requests")
        signal = np.asarray(signal)
        vad_s = np.atleast_2d(np.asarray(vad_s, np.float64))
        if signal.ndim != 1 or vad_s.ndim != 2 or vad_s.shape[1] != 2:
            raise ValueError(
                f"need signal [N] and vad [V, 2] seconds; got "
                f"{signal.shape} and {vad_s.shape}")
        req = _Request(recording, None, None, signal=signal, vad=vad_s)
        self._enqueue(req)
        return req.future

    def diarize_audio(self, recording: str, signal: np.ndarray,
                      vad_s: np.ndarray,
                      timeout: Optional[float] = None) -> ServeResult:
        return self.submit_audio(recording, signal, vad_s).result(timeout)

    def warmup(self, n_xvectors: int = 256, n_raw_dim: Optional[int] = None,
               batch_sizes: Tuple[int, ...] = (1,),
               payload: Optional[Tuple[np.ndarray, np.ndarray]] = None
               ) -> ServeResult:
        """Run recordings end to end before taking traffic: the first call
        builds the CUDA kernels and warms the allocator for the padded
        batch sizes concurrent traffic will ride in (`batch_sizes`, e.g.
        (1, 8, 16)). `payload` supplies a REAL (x_raw, timestamps) request
        body so the warmed (T, S) bucket matches production traffic.
        Each wave rides ONE chunk of exactly its padded batch size (its
        requests opt out of partial launches)."""
        batch_sizes = tuple(batch_sizes)
        if not batch_sizes or any(k < 1 for k in batch_sizes):
            raise ValueError(
                f"warmup batch_sizes must be a non-empty sequence of "
                f"positive ints, got {batch_sizes!r}")
        if payload is not None:
            x, ts = payload
            x = np.asarray(x)
            ts = np.asarray(ts, np.float64)
        else:
            d = n_raw_dim or self._diar.mean1.shape[0]
            rng = np.random.default_rng(0)
            x = rng.normal(size=(n_xvectors, d)).astype(np.float32)
            ts = np.stack([np.arange(n_xvectors) * 0.24,
                           np.arange(n_xvectors) * 0.24 + 1.44], axis=1)
        res = None
        # serialized: concurrent warmups would interleave their waves
        with self._warmup_lock:
            # phase 1: every wave's padded batch once, through the real
            # _launch_chunk, so the warmed signature is production's
            dummy = _Request("__warmup_compile__", x, ts, no_partial=True)
            self._init_one(dummy)
            if dummy.ts is not None:      # init-only configs skip phase 1
                t_pad, s_pad = bucket_shape(*dummy.ts)
                for k in batch_sizes:
                    entry = self._launch_chunk([dummy] * k, t_pad, s_pad)
                    if entry is not None:
                        entry["l1"].cpu()
            # phase 2: the end-to-end waves
            for k in batch_sizes:
                futs = [self.submit(f"__warmup_{k}_{i}__", x, ts,
                                    _no_partial=True)
                        for i in range(k)]
                res = [f.result() for f in futs][-1]
        return res

    def stats(self) -> Dict[str, object]:
        with self._lock:
            s = dict(self._stats)
            s["pending"] = self._pending
        s["uptime_s"] = round(time.time() - self._t_start, 3)
        s["queue_depth"] = self._queue.qsize()
        s["max_pending_requests"] = self._max_pending
        return s

    def close(self) -> None:
        """Requests already queued are completed, then the worker exits."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(_SHUTDOWN)
        self._worker.join()
        self._init_pool.shutdown(wait=False)
        self._pools.close()
        self._runlog.close()

    def __enter__(self) -> "DiarizationService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- worker --------------------------------------------------------------

    def _enqueue(self, req: _Request) -> None:
        # the closed check and the enqueue are one atomic step, so a request
        # never lands behind the shutdown sentinel
        with self._lock:
            if self._closed:
                raise RuntimeError("service is closed")
            self._admit(req)
            # host init starts NOW: it overlaps the batching window and any
            # chunk in flight
            req.init_future = self._init_pool.submit(self._init_one, req)
            self._queue.put(req)

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            if item is _SHUTDOWN:
                return
            batch = [item]
            deadline = time.perf_counter() + self._window_s
            stop = False
            while True:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _SHUTDOWN:
                    stop = True
                    break
                batch.append(nxt)
            try:
                if self._process(batch):
                    return             # shutdown sentinel absorbed mid-run
            except Exception as exc:   # noqa: BLE001 — never kill the worker
                for req in batch:
                    if not req.future.done():
                        self._fail(req, exc)
            if stop:
                return

    def _init_one(self, req: _Request) -> None:
        """Host init chain (f64 transform + AHC) for one request, on the
        init pool; its exceptions surface when the dispatcher collects the
        init future (per-request failure isolation)."""
        _, _, run_vb = _parse_init(self._diar.config.init)
        if req.x_raw is None:   # audio request: extract x-vectors first
            with self._extract_lock:
                segs = self.extractor.extract_file(
                    req.signal, req.vad, req.recording)
            if not segs:
                raise ValueError(
                    f"{req.recording}: no x-vectors (VAD empty or "
                    f"all segments shorter than one window)")
            req.x_raw = np.stack([s.xvector for s in segs])
            req.timestamps = np.array(
                [[s.start, s.end] for s in segs], np.float64)
            req.signal = req.vad = None
            if len(req.x_raw) > self._max_request_xvectors:
                raise ValueError(
                    f"{req.recording}: audio extracted to "
                    f"{len(req.x_raw)} x-vectors > max_request_xvectors="
                    f"{self._max_request_xvectors}")
        # a request made of NaN embeddings is an input error
        # (predict.py:185-186 drops them at extraction)
        if not np.all(np.isfinite(req.x_raw)):
            raise ValueError(
                f"{req.recording}: non-finite values in x_raw")
        x = self._diar.transform_xvectors(req.x_raw)
        req.labels = self._diar.initial_labels(x)
        if run_vb:
            T, S, _, Xi, Gi = self._diar.bucket_planes(x, req.labels)
            req.ts = (T, S)
            # synchronous uploads (module docstring): finished before the
            # init future resolves, so the dispatch thread may stack them
            req.fea_dev = torch.as_tensor(Xi, device=self.device)
            req.qinit_dev = torch.as_tensor(Gi, device=self.device)
        req.t_init_done = time.perf_counter()

    def _process(self, batch: List[_Request]) -> bool:
        """Dispatch one cohort — and every request that ARRIVES while it is
        in flight: each loop tick drains the queue into the working set.
        As init futures complete, (T, S)-bucket groups fill and full chunks
        launch at once; a group whose oldest member has waited
        partial_after_ms launches partially. Returns True if the shutdown
        sentinel was absorbed (the worker must exit)."""
        import concurrent.futures as cf
        from collections import deque

        _, _, run_vb = _parse_init(self._diar.config.init)
        with self._lock:
            self._stats["batches"] += 1
            self._stats["batched_requests"] += len(batch)
            self._stats["max_batch"] = max(self._stats["max_batch"],
                                           len(batch))

        groups: Dict[Tuple[int, int], List[_Request]] = {}
        group_born: Dict[Tuple[int, int], float] = {}
        in_flight: deque = deque()
        # bounds device memory: a launched chunk's inputs and label planes
        # stay alive until fetched
        max_in_flight = 2

        def launch(reqs, t_pad, s_pad):
            entry = self._launch_chunk(reqs, t_pad, s_pad)
            if entry is not None:
                entry["t"] = time.perf_counter()
                in_flight.append(entry)
            while len(in_flight) > max_in_flight:
                self._finish_chunk(in_flight.popleft())

        fut_to_req = {req.init_future: req for req in batch}
        pending = set(fut_to_req)
        stop = False

        # absorbed mid-cohort requests are reachable only through
        # fut_to_req: a failure here must fail THEM too
        try:

            def absorb() -> int:
                """Non-blocking queue drain into the working set; returns
                the number of requests admitted to grouping."""
                nonlocal stop
                n = 0
                while not stop:
                    try:
                        nxt = self._queue.get_nowait()
                    except queue.Empty:
                        break
                    if nxt is _SHUTDOWN:
                        stop = True
                        break
                    fut_to_req[nxt.init_future] = nxt
                    pending.add(nxt.init_future)
                    n += 1
                    with self._lock:
                        self._stats["batched_requests"] += 1
                return n

            # admission tick with idle backoff: new arrivals join the wait
            # set only at the next absorb, so waits are bounded by a short
            # tick that stretches to 250 ms on a quiet queue
            tick = 0.02
            while pending:
                tick = 0.02 if absorb() else min(tick * 2.0, 0.25)
                deadline = float("inf")
                if not stop:
                    deadline = time.perf_counter() + tick
                if groups:
                    deadline = min(deadline, min(
                        (born + self._partial_after_s
                         for key, born in group_born.items()
                         if not all(r.no_partial for r in groups[key])),
                        default=float("inf")))
                if in_flight:
                    # a launched chunk's results must not wait on unrelated
                    # stragglers either; an aged chunk still running is
                    # polled at a floored interval, not spun on
                    fetch_deadline = in_flight[0]["t"] + self._partial_after_s
                    if (fetch_deadline <= time.perf_counter()
                            and not _ready(in_flight[0])):
                        fetch_deadline = time.perf_counter() + 0.005
                    deadline = min(deadline, fetch_deadline)
                timeout = (None if deadline == float("inf")
                           else max(0.0, deadline - time.perf_counter()))
                done, pending = cf.wait(pending, timeout=timeout,
                                        return_when=cf.FIRST_COMPLETED)
                now = time.perf_counter()
                for fut in done:
                    req = fut_to_req[fut]
                    try:
                        fut.result()
                    except Exception as exc:   # noqa: BLE001
                        self._fail(req, exc)
                        continue
                    if not run_vb:
                        # init-only configs ride no device batch
                        self._finish(req, req.labels, n_iters=0, batch_size=1)
                        continue
                    key = bucket_shape(*req.ts)
                    if key not in groups:
                        groups[key] = []
                        group_born[key] = now
                    groups[key].append(req)
                    if len(groups[key]) >= chunk_cap(
                            key[0], self._max_batch_frames, self.mesh):
                        launch(groups.pop(key), *key)
                        group_born.pop(key, None)
                for key in [k for k, born in group_born.items()
                            if now - born >= self._partial_after_s
                            and not all(r.no_partial for r in groups[k])]:
                    launch(groups.pop(key), *key)
                    group_born.pop(key, None)
                # fetch aged chunks only once the device has finished them
                # (_ready does not block)
                while in_flight and (
                        time.perf_counter() - in_flight[0]["t"]
                        >= self._partial_after_s
                        and _ready(in_flight[0])):
                    self._finish_chunk(in_flight.popleft())
            for (t_pad, s_pad), reqs in sorted(groups.items()):
                cap = chunk_cap(t_pad, self._max_batch_frames, self.mesh)
                for k in range(0, len(reqs), cap):
                    launch(reqs[k:k + cap], t_pad, s_pad)
            while in_flight:
                self._finish_chunk(in_flight.popleft())
        except Exception as exc:   # noqa: BLE001 — never hang a
            for req in fut_to_req.values():   # caller's future
                if not req.future.done():
                    self._fail(req, exc)
        return stop

    def _launch_chunk(self, reqs: List[_Request], t_pad: int,
                      s_pad: int) -> Optional[dict]:
        """Run one device chunk (engine.pipeline.run_vb_chunk); returns an
        entry for _finish_chunk, or None if the launch failed (those
        requests are already failed). The engine is the service's: under a
        mesh the sharded engine's structured smoother, as vbx_tpu's."""
        try:
            # the planes were padded and uploaded at init time (_init_one):
            # the batch is a stack on the card
            l1, l2, res = run_vb_chunk(
                self._diar, [req.fea_dev for req in reqs],
                [req.qinit_dev for req in reqs], [req.ts for req in reqs],
                t_pad, s_pad, None if self.mesh else self._fb_impl,
                self.mesh)
            ready = None
            if l1.device.type == "cuda":
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(l1.device))
        except Exception as exc:   # noqa: BLE001 — fail the chunk, not the
            for req in reqs:       # service
                self._fail(req, exc)
            return None
        now = time.perf_counter()
        for req in reqs:
            req.t_launch = now
        return {"reqs": reqs, "iters": res.n_iters, "l1": l1, "l2": l2,
                "ready": ready, "B": len(reqs)}

    def _finish_chunk(self, entry: dict) -> None:
        cfg = self._diar.config
        reqs, B = entry["reqs"], entry["B"]
        try:
            l1 = entry["l1"].cpu().numpy()
            l2 = entry["l2"].cpu().numpy()
            iters = entry["iters"].cpu().numpy()
        except Exception as exc:   # noqa: BLE001 — fetch failed: fail the
            for req in reqs:       # chunk, not the service
                self._fail(req, exc)
            return
        for b, req in enumerate(reqs):
            T, S = req.ts
            labels = l1[b, :T]
            labels2 = (l2[b, :T] if cfg.output_2nd and S > 1 else None)
            self._finish(req, labels, labels2nd=labels2,
                         n_iters=int(iters[b]), batch_size=B)

    # -- result assembly -------------------------------------------------------

    def _admit(self, req: _Request) -> None:
        """Count one submit()-admitted request against the working-set
        bound. Caller holds self._lock."""
        if self._pending >= self._max_pending:
            raise ServiceOverloaded(
                f"{self._pending} requests admitted and unfinished "
                f">= max_pending_requests={self._max_pending}; every "
                f"admitted request pins padded device planes until its "
                f"chunk launches — shed load or retry after results "
                f"drain")
        self._pending += 1
        req.admitted = True

    def _release(self, req: _Request) -> None:
        """Terminal accounting for an admitted request (idempotent; safe
        on warmup's non-admitted synthetic requests)."""
        with self._lock:
            if req.admitted and not req.released:
                req.released = True
                self._pending -= 1

    def _fail(self, req: _Request, exc: Exception) -> None:
        self._release(req)
        if req.future.done():
            # a request can reach _fail twice (the warmup chunk holds the
            # same dummy request in every lane)
            return
        with self._lock:
            self._stats["requests"] += 1
            self._stats["failed"] += 1
        self._runlog.write({"event": "request_failed",
                            "recording": req.recording,
                            "error": f"{type(exc).__name__}: {exc}"})
        # a caller may have cancel()ed the pending future; the claim below
        # makes set_exception safe (a cancelled request stays counted)
        if req.future.set_running_or_notify_cancel():
            req.future.set_exception(exc)

    def _finish(self, req: _Request, labels: np.ndarray, *, n_iters: int,
                batch_size: int,
                labels2nd: Optional[np.ndarray] = None) -> None:
        self._release(req)
        if not req.future.set_running_or_notify_cancel():
            with self._lock:      # cancelled while queued or in flight
                self._stats["requests"] += 1
            self._runlog.write({"event": "request_cancelled",
                                "recording": req.recording})
            return
        start, end = req.timestamps.T
        starts, ends, out_labels = merge_adjacent_labels(start, end, labels)
        buf = io.StringIO()
        write_rttm(buf, req.recording, starts, ends, out_labels)
        rttm2 = None
        if labels2nd is not None:
            s2, e2, l2 = merge_adjacent_labels(start, end, labels2nd)
            buf2 = io.StringIO()
            write_rttm(buf2, req.recording, s2, e2, l2)
            rttm2 = buf2.getvalue()
        result = ServeResult(
            recording=req.recording, rttm=buf.getvalue(),
            labels1st=labels, n_speakers=len(np.unique(labels)),
            n_iters=n_iters,
            wall_ms=round((time.perf_counter() - req.t_submit) * 1e3, 3),
            batch_size=batch_size, labels2nd=labels2nd, rttm_2nd=rttm2)
        with self._lock:
            self._stats["requests"] += 1

        def _ms(t):
            return (round((t - req.t_submit) * 1e3, 1)
                    if t is not None else None)

        self._runlog.write({
            "event": "request", "recording": req.recording,
            "n_speakers": result.n_speakers, "n_iters": result.n_iters,
            "wall_ms": result.wall_ms, "batch_size": result.batch_size,
            "init_done_ms": _ms(req.t_init_done),
            "launched_ms": _ms(req.t_launch)})
        req.future.set_result(result)


def _ready(entry: dict) -> bool:
    """Whether a launched chunk's label planes are finished (never
    blocks): its CUDA event has completed, or it ran on the CPU."""
    return entry["ready"] is None or entry["ready"].query()
