"""HTTP serving front-end of the PyTorch/CUDA port: a warm diarization
daemon on one device (port of vbx_tpu.cli.serve).

No reference counterpart (the reference forks one OS process per recording,
AMI_run.sh:53-58); this is the deployment-shaped surface over
vbx_tpu_torch.serving.DiarizationService — models loaded once, the CUDA
kernels built once, concurrent requests micro-batched onto the card.

Endpoints (JSON unless noted):
  GET  /healthz   liveness + backend/device info
  GET  /stats     request/batch counters, uptime, queue depth
  POST /diarize   one of:
    {"recording": str, "xvectors": [[f,...]], "timestamps": [[s,e],...]}
        -> {"recording", "rttm", "n_speakers", "n_iters", "wall_ms",
            "batch_size"}
    {"xvec_ark_file": path, "segments_file": path}        (server-local)
        -> {"results": {recording: {...as above...}}, "failed": {...}}
    {"wav_file": path, "lab_file": path | "vad": [[s,e],...]}
        (server-local audio; requires --weights so the daemon holds the
        x-vector model) -> same shape as the inline form

vbx_tpu's flags plus --device (default cuda; 'cpu' runs the port on the
host explicitly), and --dtype for the x-vector model. Uses only the
standard library (ThreadingHTTPServer): requests are parsed on socket
threads and funneled into the service's dispatch thread. SIGTERM drains
and stops the daemon. Run it as `python -m vbx_tpu_torch.cli.serve ...`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from vbx_tpu_torch.cli.diarize import config_from_args
from vbx_tpu_torch.config import DATASET_PRESETS
from vbx_tpu_torch.serving import DiarizationService, ServiceOverloaded


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m vbx_tpu_torch.cli.serve",
        description="warm HTTP diarization service (PyTorch/CUDA port)")
    p.add_argument("--xvec-transform", required=True, type=str)
    p.add_argument("--plda-file", required=True, type=str)
    p.add_argument("--init", type=str, default="AHC+VB")
    p.add_argument("--preset", type=str, default=None,
                   help=f"dataset preset ({sorted(DATASET_PRESETS)}) or a "
                        ".yaml/.json config file")
    p.add_argument("--threshold", type=float, default=None)
    p.add_argument("--lda-dim", type=int, default=None)
    p.add_argument("--Fa", type=float, default=None)
    p.add_argument("--Fb", type=float, default=None)
    p.add_argument("--loopP", type=float, default=None)
    p.add_argument("--target-energy", type=float, default=None)
    p.add_argument("--init-smoothing", type=float, default=None)
    p.add_argument("--ahc-fallback-n", type=int, default=None,
                   help="requests longer than this skip AHC for "
                        "random_<K> init (long-recording fallback)")
    p.add_argument("--ahc-fallback-speakers", type=int, default=None)
    p.add_argument("--fb-impl", type=str, default=None,
                   choices=["structured", "assoc", "pallas", "pallas_bf16"])
    p.add_argument("--mesh", type=str, default=None, metavar="DPxSP",
                   help="serve over a ('dp','sp') device mesh, e.g. 4x2: "
                        "recordings data-parallel, frames sequence-"
                        "parallel (fb-impl is ignored under a mesh)")
    # x-vector extractor (optional: enables audio requests)
    p.add_argument("--weights", type=str, default=None,
                   help="x-vector model checkpoint (.pth/.onnx) — enables "
                        "wav_file requests")
    p.add_argument("--model-file", type=str, default=None,
                   help="whole pickled torch model (takes precedence over "
                        "--weights, like the reference predict.py:117-119)")
    p.add_argument("--model", type=str, default="ResNet101",
                   choices=["ResNet101", "ResNet34"])
    p.add_argument("--ndim", type=int, default=64)
    p.add_argument("--embed-dim", type=int, default=256)
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--extract-batch-size", type=int, default=128)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="x-vector model convolution dtype (cli/extract.py)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8300)
    p.add_argument("--batch-window-ms", type=float, default=20.0,
                   help="micro-batching window: how long the dispatcher "
                        "waits for batch mates after the first request")
    p.add_argument("--partial-after-ms", type=float, default=50.0,
                   help="head-of-line bound: a bucket group whose oldest "
                        "request has waited this long launches as a "
                        "partial device chunk instead of waiting for the "
                        "cohort's slowest host init (p95 control; 'inf' "
                        "disables)")
    p.add_argument("--max-batch-frames", type=int, default=2_000_000)
    p.add_argument("--max-request-xvectors", type=int, default=200_000,
                   help="reject requests longer than this (one oversized "
                        "request must not exhaust the daemon's memory)")
    p.add_argument("--max-pending-requests", type=int, default=256,
                   help="admission bound: more admitted, unfinished "
                        "requests than this answer 503")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the startup run of the common path")
    p.add_argument("--warmup-batches", type=str, default="1",
                   help="comma-separated batch sizes to run at startup "
                        "(e.g. 1,8,16)")
    p.add_argument("--runlog", type=str, default=None,
                   help="append one JSON record per request to this file")
    p.add_argument("--output-2nd", action="store_true", default=False,
                   help="include second-best speaker labels (rttm_2nd) in "
                        "responses (reference vbhmm.py:98)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; with no CUDA card pass "
                        "'cpu' explicitly)")
    return p


def make_handler(service: DiarizationService):
    class Handler(BaseHTTPRequestHandler):
        # one access-log line per request to stderr
        def log_message(self, fmt, *args):   # noqa: N802 (stdlib name)
            print(f"{self.address_string()} {fmt % args}", file=sys.stderr)

        def _reply(self, code: int, payload: dict,
                   extra_headers: dict = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra_headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):   # noqa: N802
            if self.path == "/healthz":
                self._reply(200, {
                    "status": "ok",
                    "backend": service.device.type,
                    "device": _device_name(service.device),
                    "audio": service.extractor is not None,
                    "mesh": (dict(service.mesh.shape)
                             if service.mesh is not None else None)})
            elif self.path == "/stats":
                self._reply(200, service.stats())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):   # noqa: N802
            if self.path != "/diarize":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError) as exc:
                self._reply(400, {"error": f"bad JSON body: {exc}"})
                return
            if not isinstance(body, dict):
                self._reply(400, {"error": "body must be a JSON object"})
                return
            try:
                if "xvectors" in body:
                    self._reply(200, _serve_inline(service, body))
                elif "xvec_ark_file" in body:
                    self._reply(200, _serve_ark(service, body))
                elif "wav_file" in body:
                    self._reply(200, _serve_wav(service, body))
                else:
                    self._reply(400, {
                        "error": "need 'xvectors'+'timestamps', "
                                 "'xvec_ark_file'+'segments_file', or "
                                 "'wav_file'+('lab_file'|'vad')"})
            except ServiceOverloaded as exc:
                # back-pressure is an operational state, not a fault: 503 +
                # Retry-After so load balancers and clients shed or retry
                self._reply(503, {"error": str(exc)},
                            extra_headers={"Retry-After": "1"})
            except (ValueError, KeyError, OSError) as exc:
                self._reply(400, {"error": f"{type(exc).__name__}: {exc}"})
            except Exception as exc:   # noqa: BLE001 — engine failure
                self._reply(500, {"error": f"{type(exc).__name__}: {exc}"})

    return Handler


def _device_name(device) -> str:
    if device.type == "cuda":
        import torch
        return torch.cuda.get_device_name(device)
    return str(device)


def _result_json(r) -> dict:
    out = {"recording": r.recording, "rttm": r.rttm,
           "n_speakers": r.n_speakers, "n_iters": r.n_iters,
           "wall_ms": r.wall_ms, "batch_size": r.batch_size}
    if r.rttm_2nd is not None:      # --output-2nd servers
        out["rttm_2nd"] = r.rttm_2nd
    return out


def _serve_inline(service: DiarizationService, body: dict) -> dict:
    x = np.asarray(body["xvectors"], np.float32)
    ts = np.asarray(body["timestamps"], np.float64)
    rec = str(body.get("recording", "recording"))
    return _result_json(service.diarize(rec, x, ts))


def _serve_wav(service: DiarizationService, body: dict) -> dict:
    """Server-local wav (+ VAD as a .lab path or inline [[s,e],...])."""
    from vbx_tpu_torch.io.vad import read_lab
    from vbx_tpu_torch.io.wav import read_wav

    if service.extractor is None:
        raise ValueError("this server has no x-vector model "
                         "(start vbx_tpu_torch.cli.serve with --weights)")
    wav = str(body["wav_file"])
    signal, fs = read_wav(wav)
    if fs != service.extractor.sample_rate:
        raise ValueError(
            f"{wav}: sample rate {fs} != extractor's "
            f"{service.extractor.sample_rate}")
    if "lab_file" in body:
        vad = read_lab(str(body["lab_file"]))
    elif "vad" in body:
        vad = np.asarray(body["vad"], np.float64)
    else:
        raise ValueError("wav_file requests need 'lab_file' or 'vad'")
    rec = str(body.get("recording",
                       os.path.splitext(os.path.basename(wav))[0]))
    return _result_json(service.diarize_audio(rec, signal, vad))


def _serve_ark(service: DiarizationService, body: dict) -> dict:
    """Server-local ark + segments: submit every recording concurrently so
    they micro-batch onto the device together."""
    from vbx_tpu_torch.io.ark import read_vec_ark_grouped
    from vbx_tpu_torch.io.segments import read_xvector_timing_dict

    segs = read_xvector_timing_dict(str(body["segments_file"]))
    futures = {}
    for rec, seg_names, x_raw in read_vec_ark_grouped(str(body["xvec_ark_file"])):
        names, times = segs[rec]
        if not np.all(names == np.array(seg_names)):
            raise ValueError(f"segments/ark name mismatch for {rec}")
        futures[rec] = service.submit(rec, x_raw, times)
    results, failed = {}, {}
    for rec, fut in futures.items():
        try:
            results[rec] = _result_json(fut.result())
        except Exception as exc:   # noqa: BLE001 — per-recording isolation
            failed[rec] = f"{type(exc).__name__}: {exc}"
    out = {"results": results}
    if failed:
        out["failed"] = failed
    return out


def _build_extractor(args):
    """The x-vector model and extractor, loaded as cli/extract.py loads
    them (a torch or ONNX checkpoint)."""
    import torch

    from vbx_tpu_torch.config import ExtractorConfig
    from vbx_tpu_torch.engine.extractor import XVectorExtractor

    dtype = getattr(torch, args.dtype)
    if args.weights and args.weights.endswith(".onnx"):
        from vbx_tpu_torch.models.onnx_import import load_onnx_checkpoint
        model = load_onnx_checkpoint(args.weights, feat_dim=args.ndim,
                                     dtype=dtype)
    else:
        from vbx_tpu_torch.models.resnet import load_torch_checkpoint
        model = load_torch_checkpoint(
            args.model_file or args.weights, feat_dim=args.ndim,
            embed_dim=args.embed_dim, dtype=dtype, arch=args.model)
    cfg = ExtractorConfig(feat_dim=args.ndim, embed_dim=args.embed_dim)
    return XVectorExtractor(model, args.sample_rate, config=cfg,
                            batch_size=args.extract_batch_size,
                            device=args.device)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    extractor = (_build_extractor(args)
                 if args.weights or args.model_file else None)
    mesh = None
    if args.mesh:
        from vbx_tpu_torch.parallel.mesh import parse_mesh_arg
        mesh = parse_mesh_arg(args.mesh, device=args.device)
    service = DiarizationService.from_files(
        cfg, args.plda_file, args.xvec_transform, fb_impl=args.fb_impl,
        extractor=extractor, mesh=mesh,
        batch_window_ms=args.batch_window_ms,
        partial_after_ms=args.partial_after_ms,
        max_batch_frames=args.max_batch_frames,
        max_request_xvectors=args.max_request_xvectors,
        max_pending_requests=args.max_pending_requests,
        runlog_path=args.runlog, device=args.device)
    if not args.no_warmup:
        try:
            sizes = tuple(int(k) for k in args.warmup_batches.split(",")
                          if k.strip())
        except ValueError:
            raise SystemExit(
                f"--warmup-batches must be comma-separated ints, got "
                f"{args.warmup_batches!r}")
        if not sizes or any(k < 1 for k in sizes):
            raise SystemExit(
                f"--warmup-batches needs at least one size >= 1, got "
                f"{args.warmup_batches!r} (use --no-warmup to skip warmup)")
        r = service.warmup(batch_sizes=sizes)
        print(f"warmup{list(sizes)}: {r.wall_ms:.0f} ms (kernel builds "
              f"included)", file=sys.stderr)
    httpd = ThreadingHTTPServer((args.host, args.port),
                                make_handler(service))
    print(f"vbx_tpu_torch.cli.serve listening on http://{args.host}:"
          f"{httpd.server_address[1]} (init={cfg.init}, preset={cfg.name}, "
          f"device={service.device}, audio={'yes' if extractor else 'no'})",
          file=sys.stderr, flush=True)

    # deployments stop daemons with SIGTERM: shut the socket down so
    # in-flight requests finish and queued work drains
    import signal
    import threading

    def _term(signum, frame):
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _term)
    from vbx_tpu_torch.utils.profiling import trace
    try:
        with trace():   # torch.profiler capture iff VBX_TPU_TRACE_DIR is set
            httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        service.close()
        print("vbx_tpu_torch.cli.serve: drained and stopped",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
