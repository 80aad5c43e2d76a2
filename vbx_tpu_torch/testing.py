"""Synthetic diarization inputs made from a seed: x-vectors, a PLDA model
and an x-vector transform trained on the same generator, a corpus on disk
(ark + segments + Kaldi PLDA file + transform.h5), and audio with its VAD
segments for the extractor.

The tests and chip_smoke.py drive the port (and the JAX package) through
these files, so no run needs the reference model assets. The x-vector
generator is the recipe of tests/test_reference_e2e_parity.py: K speaker
centres N(0, 0.4^2 I) in 256 dims, a speaker change with probability 0.02
per x-vector, N(0, 0.6^2 I) noise, rows length-normalized. The transform
(mean1, lda, mean2) is an LDA and the PLDA (mu, tr, psi) a two-covariance
model, both estimated on a training set drawn from that generator.
"""

from __future__ import annotations

import contextlib
import os
import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np

from vbx_tpu_torch.io.ark import write_vec_ark
from vbx_tpu_torch.io.hdf5 import write_datasets
from vbx_tpu_torch.io.rttm import merge_adjacent_labels, write_rttm
from vbx_tpu_torch.io.segments import write_segments

X_SHIFT = 0.24     # seconds between consecutive x-vectors
X_WINDOW = 1.44    # seconds each x-vector covers


def synth_recording(rng: np.random.Generator, T: int, K: int,
                    D: int = 256) -> Tuple[np.ndarray, np.ndarray]:
    """(x [T, D] float32 unit rows, true speaker index [T])."""
    centers = rng.standard_normal((K, D)) * 0.4
    z = np.zeros(T, int)
    cur = 0
    for t in range(T):
        if rng.random() < 0.02:
            cur = rng.integers(0, K)
        z[t] = cur
    x = centers[z] + 0.6 * rng.standard_normal((T, D))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(
        np.float32), z


def _class_covariances(x: np.ndarray, spk: np.ndarray):
    """(mean, within-class, between-class covariance) of labeled rows."""
    mean = x.mean(0)
    ids = np.unique(spk)
    means = np.stack([x[spk == s].mean(0) for s in ids])
    resid = x - means[np.searchsorted(ids, spk)]
    within = resid.T @ resid / len(x)
    dm = means - mean
    between = dm.T @ dm / len(ids)
    return mean, within, between


def synth_models(rng: np.random.Generator, n_speakers: int = 300,
                 per_speaker: int = 30, D: int = 256, lda_dim: int = 128):
    """(plda (mu, tr, psi), transform (mean1, lda, mean2)) as float64
    numpy arrays, estimated on a training set from the generator above."""
    import scipy.linalg

    centers = rng.standard_normal((n_speakers, D)) * 0.4
    spk = np.repeat(np.arange(n_speakers), per_speaker)
    x = centers[spk] + 0.6 * rng.standard_normal((len(spk), D))
    x /= np.linalg.norm(x, axis=1, keepdims=True)

    mean1 = x.mean(0)
    y = x - mean1
    y /= np.linalg.norm(y, axis=1, keepdims=True)
    _, within, between = _class_covariances(y, spk)
    _, vecs = scipy.linalg.eigh(between, within)
    lda = vecs[:, ::-1][:, :lda_dim]
    z = y @ lda
    mean2 = z.mean(0)

    u = z - mean2
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    mu, within, between = _class_covariances(u, spk)
    # tr whitens the within-class covariance and diagonalizes the
    # between-class one: tr W tr^T = I, tr B tr^T = diag(psi)
    psi, V = scipy.linalg.eigh(between, within)
    return (mu, V.T.copy(), psi), (mean1, lda.copy(), mean2)


def write_plda(path: str, mu: np.ndarray, tr: np.ndarray,
               psi: np.ndarray) -> None:
    """Kaldi binary <Plda> object (float64 vectors and matrix)."""
    def vec(v):
        v = np.ascontiguousarray(v, np.float64)
        return b"DV \x04" + struct.pack("<i", v.size) + v.tobytes()

    tr = np.ascontiguousarray(tr, np.float64)
    mat = (b"DM \x04" + struct.pack("<i", tr.shape[0]) + b"\x04"
           + struct.pack("<i", tr.shape[1]) + tr.tobytes())
    with open(path, "wb") as f:
        f.write(b"\x00B<Plda> " + vec(mu) + mat + vec(psi) + b"</Plda> ")


def write_transform(path: str, mean1: np.ndarray, lda: np.ndarray,
                    mean2: np.ndarray) -> None:
    """transform.h5 (HDF5; written without h5py, which readers need not
    have either — io.hdf5)."""
    write_datasets(path, {"mean1": mean1, "lda": lda, "mean2": mean2})


def write_corpus(out_dir: str, seed: int, lengths: Sequence[int],
                 speakers: Sequence[int]) -> Dict[str, object]:
    """Write a synthetic corpus: one recording per (T, K) pair.

    Returns {"ark", "segments", "plda", "transform": file paths,
    "truth": {recording: true speaker index per x-vector},
    "models": (plda tuple, transform tuple)}."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    plda, transform = synth_models(rng)
    paths = {k: os.path.join(out_dir, f) for k, f in (
        ("ark", "xvectors.ark"), ("segments", "segments"),
        ("plda", "plda"), ("transform", "transform.h5"))}
    write_plda(paths["plda"], *plda)
    write_transform(paths["transform"], *transform)
    records: List[Tuple[str, np.ndarray]] = []
    rows = []
    truth = {}
    for r, (T, K) in enumerate(zip(lengths, speakers)):
        rec = f"rec{r:03d}"
        x, z = synth_recording(rng, int(T), int(K))
        truth[rec] = z
        for i in range(int(T)):
            name = f"{rec}_{i:05d}"
            records.append((name, x[i]))
            start = round(i * X_SHIFT, 3)
            rows.append((name, rec, start, round(start + X_WINDOW, 3)))
    write_vec_ark(paths["ark"], records)
    write_segments(paths["segments"], rows)
    return {**paths, "truth": truth, "models": (plda, transform)}


AUDIO_VOICES = 3   # harmonic "voices" of synth_audio


def synth_audio(rng: np.random.Generator, seconds: float,
                fs: int = 16000) -> Tuple[np.ndarray, np.ndarray]:
    """(signal [N] float64 in [-1, 1), VAD segments [V, 2] in seconds).

    Speech turns of 0.6-8 s, separated by 0.1-0.8 s pauses, each from one
    of AUDIO_VOICES harmonic "voices" (a fundamental of 90-260 Hz with 3 %
    vibrato and 12 harmonics of decaying amplitude, syllable-rate
    amplitude modulation); low-level white noise throughout. After the
    turns, two edge cases of the extractor: a 20 ms segment (shorter than
    one 25 ms analysis window, above the 10 ms skip) and a 1.1 s one,
    whose ~110 frames give a single tail window and no full one."""
    n = int(seconds * fs)
    t = np.arange(n) / fs
    x = 0.003 * rng.standard_normal(n)
    f0s = rng.uniform(90.0, 260.0, AUDIO_VOICES)
    segs = []
    pos = 0.3
    tail_room = 2.0
    while pos + 0.6 < seconds - tail_room:
        dur = min(rng.uniform(0.6, 8.0), seconds - tail_room - pos)
        v = rng.integers(AUDIO_VOICES)
        a, b = int(pos * fs), int((pos + dur) * fs)
        tt = t[a:b]
        f0 = f0s[v] * (1.0 + 0.03 * np.sin(2 * np.pi * rng.uniform(3, 6)
                                            * tt))
        phase = 2 * np.pi * np.cumsum(f0) / fs
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(3, 5) * tt
                                 + rng.uniform(0, 2 * np.pi))
        voiced = sum(np.sin(k * phase) / k ** 1.2 for k in range(1, 13))
        x[a:b] += 0.12 * env * voiced
        segs.append((round(pos, 3), round(pos + dur, 3)))
        pos += dur + rng.uniform(0.1, 0.8)
    edge = seconds - tail_room + 0.1
    segs += [(round(edge, 3), round(edge + 0.02, 3)),
             (round(edge + 0.3, 3), round(edge + 1.4, 3))]
    return np.clip(x, -1.0, 1.0 - 2.0 ** -15), np.asarray(segs, float)


def write_audio_corpus(out_dir: str, seed: int, seconds: Sequence[float],
                       fs: int = 16000) -> Tuple[List[str], List[str],
                                                  List[str]]:
    """Write one `<name>.wav` and `<name>.lab` per entry of `seconds`
    (synth_audio) and return (names, wav paths, lab paths)."""
    from vbx_tpu_torch.io.wav import write_wav

    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)
    names, wavs, labs = [], [], []
    for i, sec in enumerate(seconds):
        name = f"audio{i:03d}"
        signal, segs = synth_audio(rng, sec, fs)
        wavs.append(os.path.join(out_dir, f"{name}.wav"))
        labs.append(os.path.join(out_dir, f"{name}.lab"))
        write_wav(wavs[-1], signal, fs)
        with open(labs[-1], "w") as f:
            f.writelines(f"{a:.3f} {b:.3f} sp\n" for a, b in segs)
        names.append(name)
    return names, wavs, labs


def write_truth_rttms(out_dir: str, truth: Dict[str, np.ndarray]) -> None:
    """One `<recording>.rttm` per entry of write_corpus's "truth", from the
    true speaker index of every x-vector and the corpus's segment times
    (merged as the pipeline merges its own labels), for the scorer."""
    os.makedirs(out_dir, exist_ok=True)
    for rec, z in truth.items():
        start = np.round(np.arange(len(z)) * X_SHIFT, 3)
        starts, ends, labels = merge_adjacent_labels(
            start, np.round(start + X_WINDOW, 3), z)
        write_rttm(os.path.join(out_dir, f"{rec}.rttm"), rec, starts, ends,
                   labels)


def frame_agreement(ref: np.ndarray, hyp: np.ndarray) -> float:
    """Share of frames whose labels agree after renaming hyp's labels to
    ref's by greedy maximal overlap (diarization is invariant to label
    permutation)."""
    from collections import Counter

    mapping = {}
    used = set()
    for (a, b), _ in Counter(zip(np.asarray(ref).tolist(),
                                 np.asarray(hyp).tolist())).most_common():
        if b not in mapping and a not in used:
            mapping[b] = a
            used.add(a)
    return float(np.mean([mapping.get(b) == a
                          for a, b in zip(ref.tolist(), hyp.tolist())]))


@contextlib.contextmanager
def host_threads(n: int = 1):
    """Cap this process's host thread pools at n inside the block: torch's
    intra-op pool, the BLAS and OpenMP pools threadpoolctl finds, and the
    native linkage's OpenMP team (restored to the core count after). A test
    suite that runs several worker processes on one host uses it: pools
    sized to the whole host in every worker oversubscribe it, and
    spin-waiting BLAS/OpenMP threads then slow each worker several-fold."""
    import torch
    from threadpoolctl import threadpool_limits

    from vbx_tpu_torch.clustering import set_native_threads

    before = torch.get_num_threads()
    torch.set_num_threads(n)
    set_native_threads(n)
    try:
        with threadpool_limits(limits=n):
            yield
    finally:
        torch.set_num_threads(before)
        set_native_threads(os.cpu_count() or 1)
