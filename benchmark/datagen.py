"""Inputs of the benchmark, made from the seed: x-vector corpora, the
synthetic PLDA and x-vector transform, audio with VAD turns, and the
ResNet101's weights.

Frozen copies (the yardstick does not move when the program's own
generators do):
- `make_corpus_sizes`: the (length, speakers) draws of
  scripts/torch_ami_scale_bench.py:make_corpus; the AMI configuration's
  recording sizes are its draws at seed 0
  (benchmark/tests/test_bench_generators.py checks them).
- `synth_models`, `_class_covariances`: vbx_tpu_torch/testing.py.
- `speech_signal`: scripts/torch_extractor_bench.py:synth_speech's signal
  (AR-filtered noise with energy modulation), here over VAD turns of
  vbx_tpu_torch/testing.py:synth_audio's pattern.

Every seed gets the same set of sizes (recording lengths, speaker
counts, VAD turns): the seed draws the content (and a corpus's order
within a pass), so the work a run does is the same from seed to seed.
"""

from typing import Dict, List, Sequence, Tuple

import numpy as np

from benchmark import kaldi_io

XVEC_DIM = 256


def make_corpus_sizes(n_meetings=18, seed=0, frames=(8000, 11000)):
    """[(T, K)] that scripts/torch_ami_scale_bench.py:make_corpus draws at
    these arguments (its generator replayed without writing files)."""
    rng = np.random.default_rng(seed)
    sizes = []
    for _ in range(n_meetings):
        T = int(rng.uniform(*frames))
        K = int(rng.integers(3, 6))
        rng.standard_normal((K, 256))
        for _ in range(T):
            if rng.random() < 0.01:
                rng.integers(0, K)
        rng.standard_normal((T, 256))
        sizes.append((T, K))
    return sizes


class Recording:
    """One recording's x-vectors: name, raw x [T, 256] float32 unit rows,
    and the (start, end) seconds of each x-vector's window."""

    def __init__(self, name: str, x: np.ndarray, step_s: float,
                 window_s: float):
        self.name = name
        self.x = x
        starts = np.round(np.arange(len(x)) * step_s, 3)
        self.times = np.stack([starts, np.round(starts + window_s, 3)], 1)

    @property
    def audio_s(self) -> float:
        """Seconds of audio the x-vectors span."""
        return float(self.times[-1, 1] - self.times[0, 0])


def recordings(spec: Dict, seed: int, prefix: str = "rec"
               ) -> List[Recording]:
    """The configuration's recordings (`spec`: sizes [[T, K], ...],
    centre_scale, noise, turn_switch_p, step_s, window_s) with content and
    order drawn from `seed`: per recording K speaker centres in the 256-d
    x-vector space, Markov turns that switch with probability
    turn_switch_p a step to a speaker drawn uniformly, unit rows."""
    rng = np.random.default_rng([seed, 0x5EED])
    sizes = [tuple(s) for s in spec["sizes"]]
    order = rng.permutation(len(sizes))
    out = []
    for r, i in enumerate(order):
        T, K = sizes[i]
        centers = rng.standard_normal((K, XVEC_DIM)) * spec["centre_scale"]
        switch = rng.random(T) < spec["turn_switch_p"]
        switch[0] = True
        pick = rng.integers(0, K, size=T)
        pick[0] = 0
        z = pick[np.maximum.accumulate(np.where(switch, np.arange(T), 0))]
        x = centers[z] + spec["noise"] * rng.standard_normal((T, XVEC_DIM))
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        out.append(Recording(f"{prefix}{r:03d}", x.astype(np.float32),
                             spec["step_s"], spec["window_s"]))
    return out


def write_corpus(d: str, recs: Sequence[Recording]) -> Tuple[str, str]:
    """The recordings as an ark and a segments file under `d`."""
    keyed = [(f"{r.name}_{i:06d}", r, i) for r in recs
             for i in range(len(r.x))]
    kaldi_io.write_vec_ark(f"{d}/xvectors.ark",
                           ((k, r.x[i]) for k, r, i in keyed))
    kaldi_io.write_segments(f"{d}/xvectors.seg",
                            ((k, r.name, *r.times[i]) for k, r, i in keyed))
    return f"{d}/xvectors.ark", f"{d}/xvectors.seg"


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


def write_models(d: str, seed: int, lda_dim: int):
    """The seed's PLDA and transform.h5 under `d`: ((plda, transform) as
    arrays, (plda path, transform path))."""
    plda, transform = synth_models(np.random.default_rng([seed, 0x50DA]),
                                   lda_dim=lda_dim)
    paths = (f"{d}/plda", f"{d}/transform.h5")
    kaldi_io.write_plda(paths[0], *plda)
    kaldi_io.write_transform(paths[1], *transform)
    return (plda, transform), paths


def vad_turns(rng: np.random.Generator, seconds: float,
              turn_s: Sequence[float], pause_s: Sequence[float]
              ) -> np.ndarray:
    """[V, 2] speech regions (seconds): turns of turn_s[0]-turn_s[1] s
    separated by pauses of pause_s[0]-pause_s[1] s, synth_audio's pattern."""
    out, t = [], float(rng.uniform(*pause_s))
    while True:
        end = t + float(rng.uniform(*turn_s))
        if end > seconds:
            break
        out.append((round(t, 2), round(end, 2)))
        t = end + float(rng.uniform(*pause_s))
    return np.array(out, np.float64)


def speech_signal(rng: np.random.Generator, n: int) -> np.ndarray:
    """n samples of AR-filtered noise with energy modulation, in [-1, 1)
    (scripts/torch_extractor_bench.py's signal: the work does not depend
    on the content)."""
    sig = rng.standard_normal(n).astype(np.float32)
    sig = np.convolve(sig, np.array([1.0, 0.7, 0.4], np.float32),
                      mode="same")
    sig *= 0.1 * (1.0 + 0.5 * np.sin(np.arange(n) * 2e-4)).astype(
        np.float32)
    return np.clip(sig, -1.0, 1.0 - 2 ** -15)


def resnet_state(seed: int, model, device: str) -> Dict[str, "object"]:
    """A state dict for `model`'s parameter names and shapes, drawn on
    `device` from the seed in one call: convolution and linear weights
    N(0, 1/fan_in), BatchNorm scales 1 + N(0, 0.1^2), shifts and running
    means N(0, 0.1^2), running variances 1 + |N(0, 0.1^2)|, float32."""
    import torch

    shapes = {k: v.shape for k, v in model.state_dict().items()
              if v.is_floating_point()}
    total = sum(int(np.prod(s)) for s in shapes.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    z = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for k, s in shapes.items():
        n = int(np.prod(s))
        v = z[off:off + n].view(s)
        off += n
        if k.endswith("weight") and len(s) > 1:
            v = v / float(np.prod(s[1:])) ** 0.5
        elif k.endswith("running_var"):
            v = 1.0 + 0.1 * v.abs()
        elif k.endswith("weight"):
            v = 1.0 + 0.1 * v
        else:
            v = 0.1 * v
        out[k] = v.contiguous()
    for k, v in model.state_dict().items():
        if not v.is_floating_point():
            out[k] = v.to(device)
    return out
