"""The port's fbank/CMVN frontend (vbx_tpu_torch.models.features) against
vbx_tpu's on the same numpy-seeded inputs.

Bars: the host constants (mel filterbank, window, nfft, fbank_config) and
the dither stream are bit-equal. fbank_htk, cmvn_floating and
cmvn_floating_masked in float64 are within 1e-9 of vbx_tpu's run in
float64 (jax.enable_x64). In float32 the two packages sum in
different orders (FFT, mel product, CMVN cumsums):
- fbank_htk within FBANK_F32_BAR = 1e-3 in the log domain (measured
  2.6e-4 at most, 8 kHz, where small mel bands make the log sensitive);
- the CMVN functions within CMVN_F32_BAR = 1e-4 over segments of 300-3000
  frames of features ~N(12, 3^2) (measured 2.7e-5 at 3000 frames: the
  cumsum's rounding grows with the segment).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import enable_x64

from vbx_tpu.models import features as jf
from vbx_tpu_torch.models import features as tf

FBANK_F32_BAR = 1e-3
CMVN_F32_BAR = 1e-4
F64_BAR = 1e-9


@pytest.mark.parametrize("fs", [8000, 16000])
def test_host_constants_are_bit_equal(fs):
    for a, b in zip(tf.fbank_config(fs), jf.fbank_config(fs)):
        np.testing.assert_array_equal(a, b)
    for winlen in (200, 256, 400, 401, 1024):
        assert tf.htk_nfft(winlen) == jf.htk_nfft(winlen)
        np.testing.assert_array_equal(tf.povey_window(winlen),
                                      jf.povey_window(winlen))
    for kw in (dict(numchans=20), dict(numchans=40, lofreq=64.0,
                                       htk_bug=True),
               dict(numchans=40, lofreq=64.0, hifreq=3000.0,
                    htk_bug=False)):
        np.testing.assert_array_equal(tf.mel_filterbank(400, fs, **kw),
                                      jf.mel_filterbank(400, fs, **kw))
    f = np.linspace(0, fs / 2, 97)
    np.testing.assert_array_equal(tf.mel(f), jf.mel(f))
    np.testing.assert_array_equal(tf.mel_inv(tf.mel(f)),
                                  jf.mel_inv(jf.mel(f)))


def test_dither_draws_vbx_tpus_numbers_and_leaves_numpys_state_alone():
    x = (np.random.default_rng(0).uniform(-1, 1, 5000) * 2 ** 15).astype(int)
    np.random.seed(3)
    ref = jf.add_dither(x, 8.0)
    np.random.seed(11)
    before = np.random.get_state()[1].copy()
    got = tf.add_dither(x, 8.0, 3)
    np.testing.assert_array_equal(np.random.get_state()[1], before)
    np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(tf.add_dither(x, 8.0, 4), ref)


FBANK_OPTIONS = {
    "extractor": dict(use_power=True, zmean_source=True),
    "magnitude": dict(use_power=False),
    "energy_first_raw": dict(energy="first"),
    "energy_last_windowed": dict(energy="last", raw_energy=False),
    "energy_last_no_enormalise": dict(energy="last", enormalise=False,
                                      escale=0.5, silfloor=30.0),
    "energy_first_no_preemphasis": dict(energy="first", preemcoef=None),
}


def _signal(fs, seconds, seed):
    rng = np.random.default_rng(seed)
    n = int(seconds * fs)
    return (np.round(rng.standard_normal(n) * 3000)
            + rng.uniform(-8, 8, n))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("option", sorted(FBANK_OPTIONS))
@pytest.mark.parametrize("fs", [8000, 16000])
def test_fbank_htk_matches_vbx_tpu(fs, option, dtype):
    window, mx, _, noverlap = jf.fbank_config(fs)
    kw = dict(noverlap=noverlap, **FBANK_OPTIONS[option])
    x = _signal(fs, 3.1, seed=fs).astype(dtype)
    window, mx = window.astype(dtype), mx.astype(dtype)
    with enable_x64():
        ref = np.asarray(jf.fbank_htk(jnp.asarray(x), jnp.asarray(window),
                                      jnp.asarray(mx), **kw))
    got = tf.fbank_htk(torch.from_numpy(x), torch.from_numpy(window),
                       torch.from_numpy(mx), **kw).numpy()
    assert got.dtype == ref.dtype == np.dtype(dtype)
    assert got.shape == ref.shape
    bar = F64_BAR if dtype == "float64" else FBANK_F32_BAR
    np.testing.assert_allclose(got, ref, rtol=0, atol=bar)


def test_fbank_htk_over_a_batch_is_each_rows_fbank():
    """The extractor computes a group of segments in one call: each row
    of the batched result is that signal's own result, energy
    normalization included (per signal)."""
    window, mx, _, noverlap = jf.fbank_config(16000)
    x = np.stack([_signal(16000, 1.0, seed=s) for s in range(3)])
    x[1] *= 0.01
    args = (torch.from_numpy(window), torch.from_numpy(mx))
    kw = dict(noverlap=noverlap, energy="first")
    batched = tf.fbank_htk(torch.from_numpy(x), *args, **kw)
    for i in range(3):
        np.testing.assert_array_equal(
            batched[i].numpy(),
            tf.fbank_htk(torch.from_numpy(x[i]), *args, **kw).numpy())


def _feats(N, dtype, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, 64)) * 3 + 12).astype(dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("norm_vars", [False, True])
@pytest.mark.parametrize("N", [120, 300, 1000, 3000])
def test_cmvn_floating_matches_vbx_tpu(N, norm_vars, dtype):
    x = _feats(N, dtype, seed=N)
    with enable_x64():
        ref = np.asarray(jf.cmvn_floating(jnp.asarray(x), 150, 149,
                                          norm_vars=norm_vars))
    got = tf.cmvn_floating(torch.from_numpy(x), 150, 149,
                           norm_vars=norm_vars).numpy()
    assert got.dtype == ref.dtype
    bar = F64_BAR if dtype == "float64" else CMVN_F32_BAR
    np.testing.assert_allclose(got, ref, rtol=0, atol=bar)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("norm_vars", [False, True])
def test_cmvn_floating_masked_matches_vbx_tpu(norm_vars, dtype):
    """Zero-padded segments of 120-3000 valid frames: the port's batched
    call against vbx_tpu's per segment, on the valid prefix; the padding
    does not reach the prefix (equal to cmvn_floating of the prefix)."""
    n_valid = [120, 300, 1000, 3000]
    x = np.zeros((len(n_valid), 3100, 64), dtype)
    for i, n in enumerate(n_valid):
        x[i, :n] = _feats(n, dtype, seed=n + 1)
        x[i, n:] = 99.0 * (i + 1)            # not zeros: must not leak in
    got = tf.cmvn_floating_masked(torch.from_numpy(x),
                                  torch.tensor(n_valid), 150, 149,
                                  norm_vars=norm_vars).numpy()
    bar = F64_BAR if dtype == "float64" else CMVN_F32_BAR
    for i, n in enumerate(n_valid):
        with enable_x64():
            ref = np.asarray(jf.cmvn_floating_masked(
                jnp.asarray(x[i]), n, 150, 149, norm_vars=norm_vars))
        np.testing.assert_allclose(got[i, :n], ref[:n], rtol=0, atol=bar)
        alone = tf.cmvn_floating(torch.from_numpy(x[i, :n]), 150, 149,
                                 norm_vars=norm_vars).numpy()
        np.testing.assert_array_equal(got[i, :n], alone)
