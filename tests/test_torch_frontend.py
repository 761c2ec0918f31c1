"""The port's log-mel frontend and wire decode against the JAX package.

Same inputs (numpy, fixed seed) through ``buzzdetect_tpu.ops.frontend`` and
``buzzdetect_torch.ops.frontend``; each test reports max |port - reference|.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from buzzdetect_tpu.models import classifier as jclf
from buzzdetect_tpu.ops import frontend as jfe
from buzzdetect_torch.models import classifier as tclf
from buzzdetect_torch.ops import frontend as tfe
from buzzdetect_torch.utils import encode_mulaw

FRAMEHOPS = [1.0, 0.5, 1 / 3, 1.5]

# Log-mel is log(mel + 1e-3) of two f32 products of ~400 and ~257 terms;
# the two frameworks sum in different orders, so values differ at f32
# rounding of the products (~1e-6 relative), amplified by at most
# 1/(mel + 1e-3) <= 1e3 in the log: 1e-4 absolute covers it with margin.
ATOL_LOG_MEL = 1e-4


def _waveform(seconds, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(seconds * 16000)) * 0.1).astype(np.float32)


@pytest.mark.parametrize('framehop', FRAMEHOPS)
def test_log_mel_matches_jax(framehop):
    jcfg = jfe.FrontendConfig().with_framehop(framehop)
    tcfg = tfe.FrontendConfig().with_framehop(framehop)
    assert tcfg.patch_hop_samples == jcfg.patch_hop_samples
    wav = _waveform(5.3, seed=4)
    n = tfe.padded_length(len(wav), tcfg)
    padded = np.zeros(n, np.float32)
    padded[:len(wav)] = wav

    ref = np.asarray(jfe.log_mel_spectrogram(jnp.asarray(padded), jcfg))
    got = tfe.log_mel_spectrogram(torch.from_numpy(padded), tcfg).numpy()
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    print(f'log_mel framehop={framehop:.3f}: max |d| = {err:.3g}')
    assert err <= ATOL_LOG_MEL

    ref_p = np.asarray(jfe.log_mel_patches(jnp.asarray(padded), jcfg))
    got_p = tfe.log_mel_patches(torch.from_numpy(padded), tcfg).numpy()
    assert got_p.shape == ref_p.shape
    assert got_p.shape[0] >= tfe.num_patches(len(wav), tcfg)
    err = float(np.abs(got_p - ref_p).max())
    print(f'patches framehop={framehop:.3f}: max |d| = {err:.3g}')
    assert err <= ATOL_LOG_MEL


def test_batched_patches_match_per_waveform():
    """(B, L) waveforms frame exactly like each row alone (the batch path
    of ChunkClassifier.predict_async_batch)."""
    cfg = tfe.FrontendConfig().with_framehop(0.5)
    n = tfe.padded_length(3 * 16000, cfg)
    wavs = np.stack([_waveform(n / 16000, seed=s) for s in (1, 2)])
    both = tfe.log_mel_patches(torch.from_numpy(wavs), cfg)
    for i in range(2):
        one = tfe.log_mel_patches(torch.from_numpy(wavs[i]), cfg)
        np.testing.assert_allclose(both[i].numpy(), one.numpy(), atol=1e-5)


@pytest.mark.parametrize('framehop', FRAMEHOPS)
def test_length_math_matches_jax(framehop):
    jcfg = jfe.FrontendConfig().with_framehop(framehop)
    tcfg = tfe.FrontendConfig().with_framehop(framehop)
    assert tfe.min_waveform_samples(tcfg) == jfe.min_waveform_samples(jcfg)
    for n in [0, 1, 100, 15359, 15360, 15599, 15600, 15601, 16000, 47999,
              48000, 200 * 16000, 200 * 16000 + 7, 3_210_001]:
        assert tfe.padded_length(n, tcfg) == jfe.padded_length(n, jcfg), n
        assert tfe.num_patches(n, tcfg) == jfe.num_patches(n, jcfg), n
        m = tfe.padded_length(n, tcfg)
        assert tfe.num_stft_frames(m, tcfg) == jfe.num_stft_frames(m, jcfg)


def test_to_float_int16_and_mulaw_match_jax():
    """Wire decode: int16 (x 1/32768) is exact in both; the mu-law expm1
    differs by f32 rounding only (<= 1e-6 on a [-1, 1] signal)."""
    rng = np.random.default_rng(9)
    x = np.clip(rng.standard_normal(4000) * 0.3, -1, 1).astype(np.float32)
    ints = (x * 32767).round().astype(np.int16)
    ref = np.asarray(jclf._to_float(jnp.asarray(ints)))
    got = tclf._to_float(torch.from_numpy(ints)).numpy()
    print(f'int16 wire: max |d| = {np.abs(got - ref).max():.3g}')
    np.testing.assert_array_equal(got, ref)

    mu = encode_mulaw(x)
    assert mu.dtype == np.int8
    ref = np.asarray(jclf._to_float(jnp.asarray(mu)))
    got = tclf._to_float(torch.from_numpy(mu)).numpy()
    err = float(np.abs(got - ref).max())
    print(f'mu-law wire: max |d| = {err:.3g}')
    assert err <= 1e-6

    f = torch.from_numpy(x)
    assert tclf._to_float(f) is f
