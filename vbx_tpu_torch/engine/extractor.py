"""x-vector extraction engine: wav + VAD -> embeddings ark + segments.

The pipeline of vbx_tpu.engine.extractor (itself the reference extractor
CLI, VBx/predict.py:81-210), step by step on torch tensors: per-file dither
(the numbers of np.random.seed(3), predict.py:163-164), per-VAD-segment
mirror padding (:169-171), 64-d log-fbank + floating CMVN (:172-174),
sliding 144-frame windows with a 24-frame hop plus the >=10-frame tail
(:179-210), the same segment keys and times, and the NaN guard (:185-186).

On the device:
- the dithered signal is uploaded once per file; each VAD segment is
  sliced and mirror-padded by index arithmetic; the segments, sorted by
  length, go through fbank + masked CMVN SEG_GROUP at a time, each group
  zero-padded to its own longest segment;
- the valid feature rows of every segment are concatenated into one
  stream, followed by seg_len zero rows, so that no window gather reads
  past its end (a torch index past the end would be a device-side assert);
- windows, full and tail alike, are gathered from that stream in fixed
  [batch_size, 64, seg_len] batches and masked past their length; the
  model's `lengths` makes a padded tail window give its unpadded
  embedding. Embeddings stay on the device until the file is done and
  cross to the host in one copy.

Only wav decode, dither and ark writing run on the host; extract_to_ark
decodes and dithers the next file on its reader thread while the device
embeds the current one. Everything runs under
`device.full_fp32_matmuls()`, so float32 convolutions and products do not
drop to TF32; the bfloat16 model runs its convolutions in bfloat16 either
way. `torch.backends.cudnn.benchmark` is left as the caller set it (off by
default): on an H100 it picked no faster algorithm for the fixed
[128, 64, 144] batch, in float32 or bfloat16, NCHW or channels_last
(scripts/torch_profile.py extract), and without it the algorithm does not
change from run to run.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vbx_tpu_torch.config import ExtractorConfig
from vbx_tpu_torch.device import DeviceLike, full_fp32_matmuls, resolve_device
from vbx_tpu_torch.models.features import (add_dither, cmvn_floating,
                                           cmvn_floating_masked,
                                           fbank_config, fbank_htk)

logger = logging.getLogger(__name__)

SEG_GROUP = 8   # VAD segments of like length computed together


@dataclasses.dataclass
class ExtractedSegment:
    key: str
    start: float
    end: float
    xvector: np.ndarray


@dataclasses.dataclass
class FileFeatures:
    """One file's features on the device: `stream` [rows, feat_dim] holds
    every kept VAD segment's valid rows, in segment order, followed by
    seg_len zero rows; `segments` lists (segnum, first row, n_frames)."""
    stream: torch.Tensor
    segments: List[Tuple[int, int, int]]
    labs: np.ndarray


class XVectorExtractor:
    """Reusable extraction engine: a ResNet x-vector model (its weights
    loaded) and the fbank configuration, on `device` ('cuda' unless the
    caller passes another; resolve_device)."""

    def __init__(self, model: torch.nn.Module, sample_rate: int,
                 config: Optional[ExtractorConfig] = None,
                 batch_size: int = 128, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.config = config or ExtractorConfig()
        self.sample_rate = sample_rate
        self.batch_size = batch_size
        window, fbank_mx, winlen, noverlap = fbank_config(sample_rate)
        self.window = torch.tensor(window, dtype=torch.float32,
                                   device=self.device)
        self.fbank_mx = torch.tensor(fbank_mx, dtype=torch.float32,
                                     device=self.device)
        self.winlen = winlen
        self.noverlap = noverlap
        self.shift = winlen - noverlap
        self.model = model.to(self.device).eval()

    # -- feature stage ----------------------------------------------------

    def _fbank(self, x: torch.Tensor) -> torch.Tensor:
        return fbank_htk(x, self.window, self.fbank_mx,
                         noverlap=self.noverlap, use_power=True,
                         zmean_source=True)

    def segment_features(self, seg_signal: np.ndarray) -> torch.Tensor:
        """Features [n_frames, 64] of a VAD segment shorter than one
        analysis window: the reference's mirror padding on the host, whose
        slices truncate on such a segment (np.r_[head-mirror, seg,
        tail-mirror], predict.py:169-171)."""
        seg = np.concatenate([
            seg_signal[self.noverlap // 2 - 1::-1],
            seg_signal,
            seg_signal[-1:-self.winlen // 2 - 1:-1]])
        x = torch.tensor(seg, dtype=torch.float32, device=self.device)
        cfg = self.config
        return cmvn_floating(self._fbank(x), cfg.cmvn_lc, cfg.cmvn_rc)

    def _group_features(self, sig: torch.Tensor, starts: torch.Tensor,
                        seg_lens: torch.Tensor, n_frames: torch.Tensor,
                        padded_len: int) -> torch.Tensor:
        """Features [G, frames, 64] of G segments of at least one window
        from the device-resident signal: slice + mirror-pad by index
        arithmetic (the reference's np.r_[head-mirror, seg, tail-mirror]),
        zero past each padded end up to `padded_len` samples, then fbank +
        CMVN over each segment's first n_frames rows."""
        h, w2 = self.noverlap // 2, self.winlen // 2
        p = torch.arange(padded_len, device=sig.device)[None, :]
        sl = seg_lens[:, None]
        idx = torch.where(p < h, h - 1 - p,
                          torch.where(p < h + sl, p - h, 2 * sl + h - 1 - p))
        # idx lies in [0, seg_len) up to the padded end (h < winlen <=
        # seg_len); the clamp only keeps the zeroed rest inside the signal
        samples = sig[starts[:, None] + idx.clamp(min=0)]
        padded = torch.where(p < h + sl + w2, samples,
                             torch.zeros((), dtype=sig.dtype,
                                         device=sig.device))
        cfg = self.config
        return cmvn_floating_masked(self._fbank(padded), n_frames,
                                    cfg.cmvn_lc, cfg.cmvn_rc)

    def dither(self, signal: np.ndarray) -> np.ndarray:
        """The file's signal in [-1, 1), scaled to 16-bit integers and
        dithered (predict.py:163-164), on the host. Thread-safe: each call
        draws from its own generator."""
        cfg = self.config
        return add_dither((signal * 2 ** 15).astype(int), cfg.dither_level,
                          cfg.dither_seed)

    def features(self, signal: np.ndarray, labs_s: np.ndarray
                 ) -> FileFeatures:
        """Dither the file, then compute every VAD segment's features on
        the device."""
        return self.dithered_features(self.dither(signal), labs_s)

    def dithered_features(self, signal: np.ndarray, labs_s: np.ndarray
                          ) -> FileFeatures:
        """Every VAD segment's features of a dithered signal, on the
        device (one upload of the signal)."""
        cfg = self.config
        fs = self.sample_rate
        labs = np.atleast_2d((np.asarray(labs_s) * fs).astype(int))

        # segments of at least one window: (padded length, segnum, start,
        # length, frames); shorter ones take the host path (the mirror
        # index needs seg_len >= winlen)
        plan: List[Tuple[int, int, int, int, int]] = []
        feas: Dict[int, torch.Tensor] = {}
        for segnum in range(len(labs)):
            seg = signal[labs[segnum, 0]:labs[segnum, 1]]
            if seg.shape[0] <= 0.01 * fs:
                continue
            if seg.shape[0] >= self.winlen:
                seg_len = int(seg.shape[0])
                padded = self.noverlap // 2 + seg_len + self.winlen // 2
                plan.append((padded, segnum, int(labs[segnum, 0]), seg_len,
                             (padded - self.winlen) // self.shift + 1))
            else:
                feas[segnum] = self.segment_features(seg)

        # sorted by length, SEG_GROUP segments at a time, each group padded
        # to its longest; every group's (start, length, frames) in one upload
        plan.sort()
        if plan:
            sig = torch.from_numpy(signal.astype(np.float32)).to(self.device)
            table = torch.tensor([it[2:] for it in plan], device=self.device)
        for g0 in range(0, len(plan), SEG_GROUP):
            group = plan[g0:g0 + SEG_GROUP]
            cols = table[g0:g0 + len(group)]
            out = self._group_features(sig, cols[:, 0], cols[:, 1],
                                       cols[:, 2], group[-1][0])
            for row, (_, segnum, _, _, n_true) in enumerate(group):
                feas[segnum] = out[row, :n_true]

        segments = []
        off = 0
        for segnum in sorted(feas):
            segments.append((segnum, off, feas[segnum].shape[0]))
            off += feas[segnum].shape[0]
        stream = torch.cat(
            [feas[s] for s in sorted(feas)]
            + [torch.zeros((cfg.seg_len, cfg.feat_dim), dtype=torch.float32,
                           device=self.device)])
        return FileFeatures(stream, segments, labs)

    # -- windowing --------------------------------------------------------

    def iter_windows(self, slen: int) -> Iterator[Tuple[int, int]]:
        """(start, length) of each extraction window over `slen` frames —
        exact reference semantics (predict.py:179-210): 144/24 sliding
        windows, then a tail of the remaining >=10 frames."""
        cfg = self.config
        start = -cfg.seg_jump
        for start in range(0, slen - cfg.seg_len, cfg.seg_jump):
            yield start, cfg.seg_len
        if slen - start - cfg.seg_jump >= cfg.min_tail_frames:
            yield start + cfg.seg_jump, slen - start - cfg.seg_jump

    def windows(self, feats: FileFeatures, name: str
                ) -> Tuple[List[int], List[int], List[Tuple[str, float,
                                                           float]]]:
        """(stream row of each window's start, its length, (key, start s,
        end s)) for every window of the file, in ark order."""
        cfg = self.config
        fs = float(self.sample_rate)
        starts: List[int] = []
        lengths: List[int] = []
        meta: List[Tuple[str, float, float]] = []
        for segnum, off, slen in feats.segments:
            t0 = feats.labs[segnum, 0] / fs
            for start, length in self.iter_windows(slen):
                starts.append(off + start)
                lengths.append(length)
                key = f"{name}_{segnum:04}-{start:08}-{start + length:08}"
                if length == cfg.seg_len:
                    end = round(t0 + start / 100.0 + cfg.seg_len / 100.0, 3)
                else:
                    end = round(feats.labs[segnum, 1] / fs, 3)
                meta.append((key, round(t0 + start / 100.0, 3), end))
        return starts, lengths, meta

    # -- embedding stage --------------------------------------------------

    def embed_batch(self, stream: torch.Tensor, starts: torch.Tensor,
                    lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Embeddings [B, embed_dim] of the windows starting at rows
        `starts` of the feature stream, `lengths` frames long: one gather,
        zeroed past each length, then the model with those lengths.
        lengths=None: every window is seg_len frames long, and neither the
        gather nor the model masks."""
        ar = torch.arange(self.config.seg_len, device=stream.device)
        win = stream[starts[:, None] + ar[None, :]]       # [B, seg_len, F]
        if lengths is not None:
            win = win * (ar[None, :] < lengths[:, None])[..., None]
        return self.model(win.transpose(1, 2).contiguous(), lengths=lengths)

    def extract_file(self, signal: np.ndarray, labs_s: np.ndarray,
                     name: str) -> List[ExtractedSegment]:
        """signal: [N] float in [-1, 1); labs_s: [V, 2] VAD (seconds)."""
        return self.extract_dithered(self.dither(signal), labs_s, name)

    def extract_dithered(self, dithered: np.ndarray, labs_s: np.ndarray,
                         name: str) -> List[ExtractedSegment]:
        """extract_file of a signal `dither` has already dithered."""
        with torch.inference_mode(), full_fp32_matmuls():
            feats = self.dithered_features(dithered, labs_s)
            starts, lengths, meta = self.windows(feats, name)
            if not meta:
                return []
            B = self.batch_size
            n = len(starts)
            pad = -n % B                   # the last batch is filled up
            seg_len = self.config.seg_len
            lengths = lengths + [seg_len] * pad
            st = torch.tensor(starts + [0] * pad, device=self.device)
            ln = torch.tensor(lengths, device=self.device)
            # a batch of full windows needs no mask (its lengths would
            # zero nothing)
            embs = torch.cat([
                self.embed_batch(feats.stream, st[i:i + B],
                                 None if min(lengths[i:i + B]) == seg_len
                                 else ln[i:i + B])
                for i in range(0, n + pad, B)])
            emb = embs[:n].float().cpu().numpy()
        out: List[ExtractedSegment] = []
        for (key, s, e), vec in zip(meta, emb):
            if np.isnan(vec).any():
                logger.warning("NaN found, not processing: %s", key)
                continue
            out.append(ExtractedSegment(key, s, e, vec))
        return out


def extract_to_ark(wav_paths: Sequence[str], lab_paths: Sequence[str],
                   names: Sequence[str], ark_path: str, segments_path: str,
                   extractor: XVectorExtractor) -> Dict[str, int]:
    """Extract every file and write Kaldi ark + segments (the stage
    boundary the diarization CLI reads, predict.py:192-193). A file that
    fails is reported on stderr and skipped, unless it is the only one
    (the reference runs one process per file, extract.sh:20-36)."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    from vbx_tpu_torch.io.ark import write_vec_ark
    from vbx_tpu_torch.io.segments import write_segments
    from vbx_tpu_torch.io.vad import read_lab
    from vbx_tpu_torch.io.wav import read_wav
    from vbx_tpu_torch.utils.timing import Timer

    def load(wav, lab):
        signal, fs = read_wav(wav)
        if signal.ndim > 1:
            signal = signal.mean(axis=1)
        return extractor.dither(signal), fs, read_lab(lab)

    counts: Dict[str, int] = {}
    vecs: List[Tuple[str, np.ndarray]] = []
    rows: List[Tuple[str, str, float, float]] = []
    files = list(zip(wav_paths, lab_paths, names))
    # one-deep prefetch: decode and dither file i+1 on a reader thread
    # while the device embeds file i
    with ThreadPoolExecutor(max_workers=1) as io_pool:
        nxt = io_pool.submit(load, *files[0][:2]) if files else None
        for idx, (wav, lab, name) in enumerate(files):
            fut, nxt = nxt, (io_pool.submit(load, *files[idx + 1][:2])
                             if idx + 1 < len(files) else None)
            try:
                with Timer(f"Processing file {name}"):
                    dithered, fs, lab_segs = fut.result()
                    if fs != extractor.sample_rate:
                        raise ValueError(
                            f"{wav}: sample rate {fs} != extractor "
                            f"{extractor.sample_rate}")
                    segs = extractor.extract_dithered(dithered, lab_segs,
                                                      name)
            except Exception as exc:   # noqa: BLE001 — per-file isolation
                if len(files) == 1:
                    raise
                print(f"ERROR: file {name!r} failed and is skipped: "
                      f"{type(exc).__name__}: {exc}", file=sys.stderr)
                continue
            counts[name] = len(segs)
            vecs.extend((s.key, s.xvector) for s in segs)
            rows.extend((s.key, name, s.start, s.end) for s in segs)
    write_vec_ark(ark_path, vecs)
    write_segments(segments_path, rows)
    return counts
