"""HTK/Kaldi-compatible log-Mel filterbank frontend on torch tensors.

Semantics of vbx_tpu.models.features (itself the reference NumPy frontend,
VBx/features.py:9-146): the same framing, preemphasis, Povey window, HTK
power-of-two NFFT rounding, HTK mel filterbank (including the `htk_bug`
low-bin zeroing), USEPOWER/ZMEANSOURCE handling, log floor at 1.0, and
Kaldi floating-window CMVN with edge-shifted windows.

- The constants (mel filterbank, window weights) are built once on the host
  in float64 NumPy: model preparation, not throughput work. These functions
  are copies of vbx_tpu's.
- The per-signal pipeline runs on whatever device its input tensor lies on:
  framing is one `unfold` view, the spectrum one batched `torch.fft.rfft`,
  the mel projection one [frames, nfft/2+1] x [nfft/2+1, nmel] product
  (at full float32: `device.full_fp32_matmuls`), the CMVN windows two
  cumsums and a gather. Every function takes leading batch dimensions, so
  the extractor computes a group of VAD segments in one call.
- Dithering: the reference adds uniform noise after `np.random.seed(3)`
  (predict.py:163-164). `add_dither` is that dither in host NumPy, the
  reference of the extractor's, which runs on the device
  (`XVectorExtractor.dither_ints`) against noise it draws once.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vbx_tpu_torch.device import full_fp32_matmuls


# ---------------------------------------------------------------------------
# host-side constants (model prep, float64 NumPy)
# ---------------------------------------------------------------------------

def mel(x):
    return 1127.0 * np.log(1.0 + np.asarray(x, float) / 700.0)


def mel_inv(x):
    return (np.exp(np.asarray(x, float) / 1127.0) - 1.0) * 700.0


def htk_nfft(winlen: int) -> int:
    """HTK rounds the FFT size up to the next power of two
    (features.py:44)."""
    return 2 ** int(np.ceil(np.log2(winlen)))


def povey_window(winlen: int) -> np.ndarray:
    """Kaldi's 'povey' window: hann^0.85 (features.py:120-121)."""
    return np.power(0.5 - 0.5 * np.cos(np.linspace(0, 2 * np.pi, winlen)),
                    0.85)


def mel_filterbank(winlen_nfft: int, fs: float, numchans: int = 20,
                   lofreq: float = 0.0, hifreq: Optional[float] = None,
                   htk_bug: bool = True) -> np.ndarray:
    """Triangular mel filterbank [nfft/2+1, numchans], HTK semantics
    (features.py:28-56): channel edges at integer FFT bins via
    floor(inv_mel(edge)/fs*nfft)+1, triangle slopes computed in mel space,
    and the HTK low-bin quirk when lofreq > 0."""
    hifreq = 0.5 * fs if not hifreq else hifreq
    nfft = htk_nfft(winlen_nfft) if winlen_nfft > 0 else -int(winlen_nfft)

    fbin_mel = mel(np.arange(nfft // 2 + 1, dtype=float) * fs / nfft)
    cbin_mel = np.linspace(mel(lofreq), mel(hifreq), numchans + 2)
    cind = np.floor(mel_inv(cbin_mel) / fs * nfft).astype(int) + 1

    # each channel c is a triangle rising over FFT bins [cind[c],
    # cind[c+1]) and falling over [cind[c+1], cind[c+2]), its slope taken
    # in mel space at each bin's mel frequency (bit-identical to the
    # reference's per-channel slice loop)
    bins = np.arange(len(fbin_mel))[:, None]             # [F, 1]
    lo, mid, hi = cind[:-2], cind[1:-1], cind[2:]        # [numchans] each
    rise = ((fbin_mel[:, None] - cbin_mel[:-2])
            / (cbin_mel[1:-1] - cbin_mel[:-2]))          # [F, numchans]
    fall = ((cbin_mel[2:] - fbin_mel[:, None])
            / (cbin_mel[2:] - cbin_mel[1:-1]))
    mfb = (np.where((bins >= lo) & (bins < mid), rise, 0.0)
           + np.where((bins >= mid) & (bins < hi), fall, 0.0))
    if lofreq > 0.0 and float(lofreq) / fs * nfft + 0.5 > cind[0] and htk_bug:
        mfb[cind[0], :] = 0.0
    return mfb


def add_dither(x: np.ndarray, level: float = 8.0, seed: int = 3
               ) -> np.ndarray:
    """HTK-style dithering (features.py:124-125): uniform noise in
    [-level, level) from `np.random.RandomState(seed)`, the numbers
    vbx_tpu's extractor draws after `np.random.seed(seed)`
    (predict.py:163), on the host.

    The extractor's main path computes the same float64 sum on the device
    (`XVectorExtractor.dither_ints`): every file takes the first N numbers
    of this one sequence, and a generator's draws in pieces concatenate to
    one draw of the whole, so the extractor keeps the noise it has drawn
    and draws only a longer file's missing tail. This function stays as
    that path's host reference."""
    rng = np.random.RandomState(seed)
    return x + level * (rng.rand(*np.shape(x)) * 2 - 1)


def fbank_config(sample_rate: int):
    """The extractor's per-bandwidth fbank configuration
    (predict.py:145-158): 8 kHz -> (200, 120, 3700 Hz); 16 kHz ->
    (400, 240, 7600 Hz); 64 channels, 20 Hz low cut, povey window."""
    if sample_rate == 8000:
        winlen, noverlap, hifreq = 200, 120, 3700
    elif sample_rate == 16000:
        winlen, noverlap, hifreq = 400, 240, 7600
    else:
        raise ValueError(f"unsupported sample rate {sample_rate}")
    window = povey_window(winlen)
    fbank_mx = mel_filterbank(winlen, sample_rate, numchans=64,
                              lofreq=20.0, hifreq=hifreq, htk_bug=False)
    return window, fbank_mx, winlen, noverlap


# ---------------------------------------------------------------------------
# device-side pipeline (torch, batched over leading dimensions)
# ---------------------------------------------------------------------------

def frame_signal(x: torch.Tensor, window: int, shift: int) -> torch.Tensor:
    """[..., N] -> [..., num_frames, window], a strided view
    (reference strided view, features.py:9-12)."""
    return x.unfold(-1, window, shift)


def fbank_htk(x: torch.Tensor, window_weights: torch.Tensor,
              fbank_mx: torch.Tensor, *, noverlap: int,
              nfft: Optional[int] = None, use_power: bool = True,
              zmean_source: bool = False,
              preemcoef: Optional[float] = 0.97,
              energy: Optional[str] = None, raw_energy: bool = True,
              enormalise: bool = True, escale: float = 0.1,
              silfloor: float = 50.0) -> torch.Tensor:
    """Log mel-filterbank features [..., num_frames, numchans] of signals
    [..., N], in x's dtype on x's device.

    vbx_tpu.models.features.fbank_htk's options: USEPOWER=False gives
    magnitude spectra; `energy` appends the HTK log-energy coefficient as
    the 'first' or 'last' column, computed before pre-emphasis and
    windowing with raw_energy (RAWENERGY), max-normalized over each
    signal's frames with the silence floor under enormalise
    (ENORMALISE/ESCALE/SILFLOOR). The extractor uses none of the energy
    options.
    """
    winlen = window_weights.shape[0]
    if energy not in (None, "first", "last"):
        raise ValueError(f"energy must be None, 'first' or 'last'; "
                         f"got {energy!r}")
    if nfft is None:
        nfft = htk_nfft(winlen)
    frames = frame_signal(x, winlen, winlen - noverlap)
    if zmean_source:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    log_e = None
    if energy is not None and raw_energy:
        log_e = torch.log((frames * frames).sum(dim=-1))
    if preemcoef is not None:
        shifted = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - preemcoef * shifted
    frames = frames * window_weights
    if energy is not None and not raw_energy:
        log_e = torch.log((frames * frames).sum(dim=-1))
    spec = torch.fft.rfft(frames, n=nfft)
    power = spec.real ** 2 + spec.imag ** 2
    if not use_power:
        power = torch.sqrt(power)
    with full_fp32_matmuls():
        mel_e = torch.matmul(power, fbank_mx)
    out = torch.log(torch.clamp(mel_e, min=1.0))
    if energy is None:
        return out
    if enormalise:
        log_e = (log_e - log_e.amax(dim=-1, keepdim=True)) * escale + 1.0
        min_val = -np.log(10.0 ** (silfloor / 10.0)) * escale + 1.0
        log_e = torch.clamp(log_e, min=min_val)
    cols = ([log_e[..., None], out] if energy == "first"
            else [out, log_e[..., None]])
    return torch.cat(cols, dim=-1)


def _cmvn(x: torch.Tensor, win_start: torch.Tensor, win_len: torch.Tensor,
          norm_vars: bool) -> torch.Tensor:
    """Subtract (and divide by) the windowed means of x [..., N, dim]:
    window i covers rows [win_start[..., i], win_start + win_len)."""
    zeros = torch.zeros_like(x[..., :1, :])
    idx_lo = win_start[..., None].expand(*win_start.shape, x.shape[-1])
    idx_hi = (win_start + win_len)[..., None].expand_as(idx_lo)
    denom = win_len[..., None].to(x.dtype)

    def window_mean(v):
        f = torch.cat([zeros, torch.cumsum(v, dim=-2)], dim=-2)
        return (torch.gather(f, -2, idx_hi)
                - torch.gather(f, -2, idx_lo)) / denom

    x = x - window_mean(x)
    if norm_vars:
        x = x / torch.sqrt(window_mean(x * x))
    return x


def cmvn_floating(x: torch.Tensor, lc: int, rc: int,
                  norm_vars: bool = False) -> torch.Tensor:
    """Kaldi-style floating-window mean (and optionally variance)
    normalization of x [..., N, dim] (features.py:128-146): fixed-size
    windows shifted, not shrunk, at the edges; global stats when the
    segment is shorter than the window."""
    N = x.shape[-2]
    win_len = min(N, lc + rc + 1)
    ar = torch.arange(-lc, N - lc, device=x.device)
    win_start = torch.clamp(torch.clamp(ar, max=N - win_len), min=0)
    win_start = win_start.expand(*x.shape[:-2], N)
    return _cmvn(x, win_start, torch.full_like(win_start, win_len),
                 norm_vars)


def cmvn_floating_masked(x: torch.Tensor, n_valid, lc: int, rc: int,
                         norm_vars: bool = False) -> torch.Tensor:
    """cmvn_floating for zero-padded x [..., N, dim] whose first `n_valid`
    rows (an int, or a tensor of the leading shape) are real: the valid
    prefix comes out as cmvn_floating of that prefix alone (padded rows
    enter the cumsums after every window read, and no window index passes
    n_valid)."""
    N = x.shape[-2]
    n_valid = torch.as_tensor(n_valid, device=x.device).expand(x.shape[:-2])
    win_len = torch.clamp(n_valid, max=lc + rc + 1)[..., None]
    ar = torch.arange(-lc, N - lc, device=x.device)
    win_start = torch.clamp(
        torch.minimum(ar, n_valid[..., None] - win_len), min=0)
    return _cmvn(x, win_start, win_len.expand_as(win_start), norm_vars)
