"""Plain x-vector extraction, the reference the extraction cell is judged
against: log-Mel filterbank and floating CMVN in float64 NumPy, the
144/24-frame windows with their tails, and ResNet101 in plain torch
float32 with TF32 off.

A frozen re-statement of VBx (github.com/BUTSpeechFIT/VBx): predict.py's
per-segment loop (mirror padding, fbank_htk with USEPOWER and ZMEANSOURCE,
cmvn_floating_kaldi without variance normalization, windows and keys),
features.py's framing, preemphasis and Povey window, and resnet.py's
ResNet101 with statistics pooling. The filterbank and window constants
are copied from vbx_tpu_torch/models/features.py (mel, mel_inv,
htk_nfft, povey_window, mel_filterbank), which states VBx's features.py.
It imports nothing of the program. Parameter names follow VBx's modules,
so one state dict loads here and into the program's model.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def mel(x):
    return 1127.0 * np.log(1.0 + np.asarray(x, float) / 700.0)


def mel_inv(x):
    return (np.exp(np.asarray(x, float) / 1127.0) - 1.0) * 700.0


def htk_nfft(winlen: int) -> int:
    return 2 ** int(np.ceil(np.log2(winlen)))


def povey_window(winlen: int) -> np.ndarray:
    return np.power(0.5 - 0.5 * np.cos(np.linspace(0, 2 * np.pi, winlen)),
                    0.85)


def mel_filterbank(winlen_nfft: int, fs: float, numchans: int = 20,
                   lofreq: float = 0.0, hifreq: Optional[float] = None,
                   htk_bug: bool = True) -> np.ndarray:
    hifreq = 0.5 * fs if not hifreq else hifreq
    nfft = htk_nfft(winlen_nfft) if winlen_nfft > 0 else -int(winlen_nfft)
    fbin_mel = mel(np.arange(nfft // 2 + 1, dtype=float) * fs / nfft)
    cbin_mel = np.linspace(mel(lofreq), mel(hifreq), numchans + 2)
    cind = np.floor(mel_inv(cbin_mel) / fs * nfft).astype(int) + 1
    bins = np.arange(len(fbin_mel))[:, None]
    lo, mid, hi = cind[:-2], cind[1:-1], cind[2:]
    rise = ((fbin_mel[:, None] - cbin_mel[:-2])
            / (cbin_mel[1:-1] - cbin_mel[:-2]))
    fall = ((cbin_mel[2:] - fbin_mel[:, None])
            / (cbin_mel[2:] - cbin_mel[1:-1]))
    mfb = (np.where((bins >= lo) & (bins < mid), rise, 0.0)
           + np.where((bins >= mid) & (bins < hi), fall, 0.0))
    if lofreq > 0.0 and float(lofreq) / fs * nfft + 0.5 > cind[0] and htk_bug:
        mfb[cind[0], :] = 0.0
    return mfb


def fbank_config(sample_rate: int):
    """predict.py:145-158: (window, filterbank, winlen, noverlap)."""
    winlen, noverlap, hifreq = {8000: (200, 120, 3700),
                                16000: (400, 240, 7600)}[sample_rate]
    return (povey_window(winlen),
            mel_filterbank(winlen, sample_rate, numchans=64, lofreq=20.0,
                           hifreq=hifreq, htk_bug=False), winlen, noverlap)


def dither(pcm: np.ndarray, level: float = 8.0, seed: int = 3
           ) -> np.ndarray:
    """predict.py:163-164: the 16-bit samples plus uniform noise in
    [-level, level) after np.random.seed(seed)."""
    rng = np.random.RandomState(seed)
    return pcm.astype(np.float64) + level * (rng.rand(len(pcm)) * 2 - 1)


def fbank_htk(x: np.ndarray, window: np.ndarray, noverlap: int,
              fbank_mx: np.ndarray) -> np.ndarray:
    """features.fbank_htk(USEPOWER=True, ZMEANSOURCE=True): framing,
    frame mean removed, preemphasis 0.97, window, |rfft|^2, mel, log
    floored at 1."""
    winlen = window.size
    shift = winlen - noverlap
    n = (len(x) - winlen) // shift + 1
    idx = np.arange(winlen)[None, :] + shift * np.arange(n)[:, None]
    fr = x.astype(float)[idx]
    fr -= fr.mean(axis=1)[:, None]
    fr = fr - np.c_[fr[:, :1], fr[:, :-1]] * 0.97
    fr *= window
    spec = np.fft.rfft(fr, htk_nfft(winlen))
    power = spec.real ** 2 + spec.imag ** 2
    return np.log(np.maximum(1.0, power @ fbank_mx))


def cmvn_floating_kaldi(x: np.ndarray, lc: int, rc: int) -> np.ndarray:
    """features.cmvn_floating_kaldi(norm_vars=False)."""
    N, dim = x.shape
    win_len = min(N, lc + rc + 1)
    win_start = np.maximum(np.minimum(np.arange(-lc, N - lc), N - win_len),
                           0)
    f = np.r_[np.zeros((1, dim)), np.cumsum(x, 0)]
    return x - (f[win_start + win_len] - f[win_start]) / win_len


def segment_features(sig: np.ndarray, lab: Tuple[int, int], cfg: dict
                     ) -> np.ndarray:
    """predict.py:165-175 for one VAD segment of the dithered signal:
    mirror padding, fbank, CMVN, as float32."""
    window, fbank_mx, winlen, noverlap = cfg["fbank"]
    seg = sig[lab[0]:lab[1]]
    seg = np.r_[seg[noverlap // 2 - 1::-1], seg, seg[-1:-winlen // 2 - 1:-1]]
    fea = fbank_htk(seg, window, noverlap, fbank_mx)
    return cmvn_floating_kaldi(fea, cfg["cmvn_lc"], cfg["cmvn_rc"]).astype(
        np.float32)


def windows(name: str, labs_s: np.ndarray, n_samples: int, cfg: dict
            ) -> List[Tuple[str, float, float, int, int, int]]:
    """predict.py:176-210's windows of a file in ark order: (key, start s,
    end s, segment, first frame, frames)."""
    fs = cfg["sample_rate"]
    _, _, winlen, noverlap = cfg["fbank"]
    shift = winlen - noverlap
    labs = (np.asarray(labs_s) * fs).astype(int)
    out = []
    L, J = cfg["seg_len"], cfg["seg_jump"]
    for segnum, (a, b) in enumerate(labs):
        n = min(b, n_samples) - a
        if n <= 0.01 * fs:
            continue
        padded = (min(noverlap // 2, n) + n + min(winlen // 2, n))
        slen = (padded - winlen) // shift + 1
        t0 = a / fs
        start = -J
        for start in range(0, slen - L, J):
            out.append((f"{name}_{segnum:04}-{start:08}-{start + L:08}",
                        round(t0 + start / 100.0, 3),
                        round(t0 + start / 100.0 + L / 100.0, 3),
                        segnum, start, L))
        if slen - start - J >= cfg["min_tail_frames"]:
            s = start + J
            out.append((f"{name}_{segnum:04}-{s:08}-{slen:08}",
                        round(t0 + s / 100.0, 3), round(b / fs, 3),
                        segnum, s, slen - s))
    return out


class Bottleneck(nn.Module):
    """resnet.py's Bottleneck: 1x1, 3x3 (stride), 1x1 x4, projection
    shortcut."""
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * 4
        self.conv1 = nn.Conv2d(in_planes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out)
        self.shortcut = nn.Sequential()
        if stride != 1 or in_planes != out:
            self.shortcut = nn.Sequential(
                nn.Conv2d(in_planes, out, 1, stride=stride, bias=False),
                nn.BatchNorm2d(out))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + self.shortcut(x))


class ResNet101(nn.Module):
    """resnet.py's ResNet101 x-vector model: 3x3 stem, Bottleneck stages
    (3, 4, 23, 3) at strides (1, 2, 2, 2), mean and standard deviation
    over time, the embedding layer."""

    def __init__(self, feat_dim: int = 64, embed_dim: int = 256,
                 m_channels: int = 32, blocks: Sequence[int] = (3, 4, 23, 3)):
        super().__init__()
        self.conv1 = nn.Conv2d(1, m_channels, 3, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(m_channels)
        cin = m_channels
        for i, (n, stride) in enumerate(zip(blocks, (1, 2, 2, 2)), start=1):
            planes = m_channels * 2 ** (i - 1)
            layers = []
            for j in range(n):
                layers.append(Bottleneck(cin, planes, stride if j == 0 else 1))
                cin = planes * 4
            setattr(self, f"layer{i}", nn.Sequential(*layers))
        self.embedding = nn.Linear(cin * (feat_dim // 8) * 2, embed_dim)
        self.eval()

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x[:, None])))
        y = self.layer4(self.layer3(self.layer2(self.layer1(y))))
        mean = y.mean(dim=-1)
        std = torch.sqrt((y * y).mean(dim=-1) - mean ** 2 + 1e-10)
        return self.embedding(torch.cat([mean.flatten(1), std.flatten(1)],
                                        1))


def embed(model: nn.Module, feats: Sequence[np.ndarray], device: str,
          tf32: bool = False) -> np.ndarray:
    """Embeddings [n, embed_dim] of windows [frames, feat_dim], each run at
    its own length, in float32 with TF32 `tf32` (False: the reference;
    True: the control)."""
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        out: Dict[int, np.ndarray] = {}
        by_len: Dict[int, List[int]] = {}
        for i, f in enumerate(feats):
            by_len.setdefault(len(f), []).append(i)
        with torch.inference_mode():
            for _, idx in sorted(by_len.items()):
                x = torch.tensor(np.stack([feats[i].T for i in idx]),
                                 dtype=torch.float32, device=device)
                e = model(x).cpu().numpy()
                out.update(zip(idx, e))
        return np.stack([out[i] for i in range(len(feats))])
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = keep
