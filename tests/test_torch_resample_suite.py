"""tests/test_resample.py, case for case, against ``buzzdetect_torch``
(same function names, parametrisations and assertions). Edits: the port's
``resample`` takes and returns tensors on the input's device, so each
case passes ``torch.from_numpy(x)`` (a CPU tensor) and reads the result
with ``.numpy()``; the identity case's dtype contract is the tensor's
(``torch.float32``), including an int16 input. The oracle is the JAX
case's own, ``scipy.signal.resample_poly``, independent of both packages:
each case prints max |port - scipy| (the scipy case, away from the edges)
beside max |port - JAX| on the same input.

The JAX package's docstring:
Device-side polyphase resampler vs scipy.signal.resample_poly.
"""

import numpy as np
import pytest
import torch

from buzzdetect_torch.ops.resample import resample

scipy_signal = pytest.importorskip('scipy.signal')

RNG = np.random.default_rng(0)


def _vs_jax(x, orig, target, got):
    from buzzdetect_tpu.ops.resample import resample as jresample
    ref = np.asarray(jresample(x, orig, target))
    err = float(np.abs(got - ref).max())
    print(f'{orig} -> {target} {x.shape}: max |port - JAX| = {err:.3g}')
    return err


@pytest.mark.parametrize('orig,target', [
    (48000, 16000), (44100, 16000), (32000, 16000), (22050, 16000),
    (8000, 16000),
])
def test_matches_scipy_polyphase(orig, target):
    t = np.arange(int(0.5 * orig)) / orig
    x = (0.5 * np.sin(2 * np.pi * 440 * t)
         + 0.1 * RNG.standard_normal(len(t))).astype(np.float32)

    ours = resample(torch.from_numpy(x), orig, target).numpy()
    n_expected = -(-len(x) * target // orig)
    assert len(ours) == n_expected

    from math import gcd
    g = gcd(orig, target)
    theirs = scipy_signal.resample_poly(x, target // g, orig // g)
    # compare away from the edges (different edge-padding conventions)
    m = min(len(ours), len(theirs))
    a, b = ours[100:m - 100], theirs[100:m - 100]
    print(f'{orig} -> {target}: max |port - scipy| = '
          f'{float(np.abs(a - b).max()):.3g}')
    _vs_jax(x, orig, target, ours)
    # signals are O(0.5); agreement to ~1e-2 abs = same filter family
    assert np.abs(a - b).max() < 2e-2
    # and near-perfect correlation
    corr = np.corrcoef(a, b)[0, 1]
    assert corr > 0.9995


def test_tone_preserved_through_resample():
    orig, target = 44100, 16000
    t = np.arange(orig) / orig
    x = np.sin(2 * np.pi * 1000 * t).astype(np.float32)
    y = resample(torch.from_numpy(x), orig, target).numpy()
    spec = np.abs(np.fft.rfft(y[:8192] * np.hanning(8192)))
    peak_hz = spec.argmax() * target / 8192
    print(f'tone: peak at {peak_hz} Hz')
    _vs_jax(x, orig, target, y)
    assert abs(peak_hz - 1000) < 5


def test_identity_when_rates_equal():
    x = RNG.standard_normal(1000).astype(np.float32)
    y = resample(torch.from_numpy(x), 16000, 16000)
    assert y.dtype == torch.float32
    np.testing.assert_array_equal(y.numpy(), x)
    # the dtype contract must not depend on the rate pair: every path
    # returns float32, including the passthrough
    yi = resample(torch.from_numpy(x.astype(np.int16)), 16000, 16000)
    assert yi.dtype == torch.float32


def test_batched():
    x = RNG.standard_normal((3, 32000)).astype(np.float32)
    y = resample(torch.from_numpy(x), 32000, 16000).numpy()
    single = resample(torch.from_numpy(x[1]), 32000, 16000).numpy()
    assert y.shape == (3, 16000)
    _vs_jax(x, 32000, 16000, y)
    np.testing.assert_allclose(y[1], single, atol=1e-6)
