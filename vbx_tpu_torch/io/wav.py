"""First-party RIFF/WAVE reader (the reference uses libsndfile via
soundfile, predict.py:15,142; wav decode is plain host I/O and needs
neither). A copy of vbx_tpu's reader.

Supports PCM 8/16/24/32-bit and IEEE float32/64, mono or multichannel,
returning float64 samples normalized to [-1, 1) exactly like
soundfile.read's default. read_wav_pcm16 hands a 16-bit PCM mono file's
samples over as the int16 it stores: they are the integers the
extractor's dither adds its noise to."""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

_PCM_DTYPES = {8: np.uint8, 16: "<i2", 32: "<i4"}


def _chunks(path: str) -> Tuple[Tuple[int, int, int, int], bytearray]:
    """((format, channels, sample rate, bits), data chunk) of a RIFF/WAVE
    file; the data is read into a writable buffer."""
    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) < 12:
            raise ValueError(f"{path}: not a RIFF/WAVE file (truncated)")
        riff, _size, wave = struct.unpack("<4sI4s", head)
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, csize = struct.unpack("<4sI", hdr)
            if cid == b"fmt ":
                fmt = f.read(csize)
            elif cid == b"data":
                data = bytearray(csize)
                del data[f.readinto(data):]         # a truncated file
            else:
                f.seek(csize + (csize & 1), 1)
                continue
            if csize & 1:
                f.seek(1, 1)
            if fmt is not None and data is not None:
                break
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")

    (audio_fmt, channels, rate, _brate, _balign,
     bits) = struct.unpack("<HHIIHH", fmt[:16])
    if audio_fmt == 0xFFFE and len(fmt) >= 40:     # WAVE_FORMAT_EXTENSIBLE
        audio_fmt = struct.unpack("<H", fmt[24:26])[0]
    return (audio_fmt, channels, rate, bits), data


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """-> (samples [N] or [N, C] float64 in [-1, 1), sample_rate)."""
    head, data = _chunks(path)
    return _decode(path, head, data), head[2]


def read_wav_pcm16(path: str) -> Tuple[np.ndarray, int]:
    """-> (samples, sample_rate): a 16-bit PCM mono file's samples as the
    int16 it stores, with no float pass; any other file's samples as
    read_wav returns them (float64, [N] or [N, C])."""
    head, data = _chunks(path)
    audio_fmt, channels, rate, bits = head
    if (audio_fmt, channels, bits) == (1, 1, 16):
        return np.frombuffer(data, dtype="<i2"), rate
    return _decode(path, head, data), rate


def _decode(path: str, head: Tuple[int, int, int, int],
            data: bytearray) -> np.ndarray:
    """The data chunk as float64 samples in [-1, 1), [N] or [N, C]."""
    audio_fmt, channels, _rate, bits = head
    if audio_fmt == 1:                              # PCM
        if bits == 24:
            raw = np.frombuffer(data, dtype=np.uint8)
            raw = raw[:len(raw) - len(raw) % 3].reshape(-1, 3)
            ints = (raw[:, 0].astype(np.int32)
                    | (raw[:, 1].astype(np.int32) << 8)
                    | (raw[:, 2].astype(np.int32) << 16))
            ints = (ints << 8) >> 8                 # sign-extend
            x = ints.astype(np.float64) / 2 ** 23
        elif bits in _PCM_DTYPES:
            arr = np.frombuffer(data, dtype=_PCM_DTYPES[bits])
            if bits == 8:                           # unsigned, offset binary
                x = (arr.astype(np.float64) - 128.0) / 128.0
            else:
                x = arr.astype(np.float64) / 2 ** (bits - 1)
        else:
            raise ValueError(f"{path}: unsupported PCM width {bits}")
    elif audio_fmt == 3:                            # IEEE float
        if bits == 32:
            dt = "<f4"
        elif bits == 64:
            dt = "<f8"
        else:
            raise ValueError(f"{path}: unsupported IEEE-float width {bits}")
        x = np.frombuffer(data, dtype=dt).astype(np.float64)
    else:
        raise ValueError(f"{path}: unsupported wav format {audio_fmt}")

    if channels > 1:
        x = x[:len(x) - len(x) % channels].reshape(-1, channels)
    return x


def write_wav(path: str, x: np.ndarray, sample_rate: int) -> None:
    """Write float samples in [-1, 1) as 16-bit PCM (test fixture helper)."""
    x = np.asarray(x)
    pcm = np.clip(np.rint(x * 32768.0), -32768, 32767).astype("<i2")
    channels = 1 if pcm.ndim == 1 else pcm.shape[1]
    data = pcm.tobytes()
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", 36 + len(data), b"WAVE"))
        f.write(struct.pack("<4sI", b"fmt ", 16))
        f.write(struct.pack("<HHIIHH", 1, channels, sample_rate,
                            sample_rate * channels * 2, channels * 2, 16))
        f.write(struct.pack("<4sI", b"data", len(data)))
        f.write(data)
