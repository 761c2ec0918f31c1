"""The port's model surface against the JAX package: embed, weights, and
ChunkClassifier on the real model_general_v3 bundle.

Inputs are numpy with fixed seeds; the port runs with device='cpu' (its
plain versions), the JAX side on its CPU backend.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from buzzdetect_tpu import config as jcfg
from buzzdetect_tpu.models import yamnet as jyam
from buzzdetect_tpu.models.classifier import ChunkClassifier as JaxClassifier
from buzzdetect_torch.models import yamnet as tyam
from buzzdetect_torch.models.classifier import ChunkClassifier
from buzzdetect_torch.models.weights import params_from_numpy

BUNDLE = os.path.join(jcfg.DIR_REPO, 'models', 'model_general_v3',
                      'model.npz')
# Embeddings: both sides exact f32, 14 layers summed in different orders;
# |embedding| is O(1), observed differences ~1e-7 (see test output).
ATOL_EMBED = 2e-4
# Scores: the BASELINE.md parity budget (expect ~1e-5).
ATOL_SCORE = 1e-3


@pytest.fixture(scope='module')
def folded():
    return jyam.fold_batchnorm(jyam.init_raw_params(seed=7))


@pytest.fixture(scope='module')
def bundle():
    with np.load(BUNDLE) as z:
        return {k: z[k] for k in z.files}


def _patches(b, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, 96, 64)).astype(np.float32)


@pytest.mark.parametrize('conv', ['pallas', 'xla'])
def test_embed_matches_jax(folded, conv):
    """conv='pallas' is the TPU main path's function (interpret mode here);
    'xla' the portable one. B = 5 is ragged against every block size."""
    patches = _patches(5, seed=2)
    jparams = {k: jnp.asarray(v) for k, v in folded.items()}
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jyam.embed(jparams, jnp.asarray(patches), conv=conv))
    got = tyam.embed(params_from_numpy(folded)['yamnet'],
                     torch.from_numpy(patches)).numpy()
    assert got.shape == ref.shape == (5, 1024)
    err = float(np.abs(got - ref).max())
    print(f'embed vs conv={conv}: max |d| = {err:.3g}')
    assert err <= ATOL_EMBED


def test_params_from_numpy_raw_folded_and_bare_agree():
    raw = jyam.init_raw_params(seed=5)
    rng = np.random.default_rng(0)
    for k in raw:  # non-trivial BatchNorm statistics
        if k.endswith('/bn_var'):
            raw[k] = rng.uniform(0.5, 2.0, raw[k].shape).astype(np.float32)
        elif k.endswith(('/bn_mean', '/bn_beta')):
            raw[k] = rng.normal(0, 0.1, raw[k].shape).astype(np.float32)
    folded = jyam.fold_batchnorm(raw)
    head = {'head/kernel': np.ones((1024, 13), np.float32),
            'head/bias': np.zeros(13, np.float32)}
    variants = [
        params_from_numpy({**{f'yamnet_raw/{k}': v for k, v in raw.items()},
                           **head}),
        params_from_numpy({**{f'yamnet/{k}': v for k, v in folded.items()},
                           **head}),
        params_from_numpy(folded),
    ]
    ref = variants[1]['yamnet']
    for p in variants:
        assert set(p['yamnet']) == set(ref)
        for k in ref:
            torch.testing.assert_close(p['yamnet'][k], ref[k], rtol=0,
                                       atol=0)
    assert 'head' in variants[0] and 'head' not in variants[2]
    # kernel layouts: depthwise (9, C) in tap order, pointwise (C, F)
    y = ref
    dw = folded['layer2/depthwise_conv/kernel']            # (3, 3, 1, 32)
    np.testing.assert_array_equal(
        y['layer2/depthwise_conv/kernel'][1 * 3 + 2].numpy(), dw[1, 2, 0])
    assert tuple(y['layer14/pointwise_conv/kernel'].shape) == (1024, 1024)
    assert tuple(y['layer1/conv/kernel'].shape) == (32, 1, 3, 3)
    with pytest.raises(ValueError, match='yamnet'):
        params_from_numpy(head)


@pytest.fixture(scope='module')
def classifiers(bundle):
    return (JaxClassifier(bundle, transfer_dtype='int16'),
            ChunkClassifier(bundle, device='cpu', transfer_dtype='int16'))


def _wave(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    tone = 0.2 * np.sin(2 * np.pi * 330 * t) * (t % 2 < 1)
    return (tone + rng.standard_normal(len(t)) * 0.05).astype(np.float32)


@pytest.mark.parametrize('seconds', [199.68, 37.3], ids=['full', 'ragged'])
def test_classifier_predict_matches_jax(classifiers, seconds):
    """One full default chunk (chunklength 200 rounds to 199.68 s, 208
    whole frames) and one ragged chunk, on the real bundle."""
    jclf, tclf = classifiers
    wav = _wave(seconds, seed=int(seconds))
    ref = jclf.predict(wav)
    got = tclf.predict(wav)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    print(f'predict {seconds}s: {got.shape}, max |dscore| = {err:.3g}')
    assert err <= ATOL_SCORE


def test_classifier_batch_matches_jax(classifiers):
    jclf, tclf = classifiers
    wavs = [_wave(s, seed=i) for i, s in enumerate((20.0, 13.37, 20.0))]
    ref, ref_n = jclf.predict_async_batch(wavs)
    got, got_n = tclf.predict_async_batch(wavs)
    assert got_n == ref_n
    ref, got = np.asarray(ref), got.numpy()
    for i, n in enumerate(got_n):
        err = float(np.abs(got[i, :n] - ref[i, :n]).max())
        print(f'batch row {i}: n_valid {n}, max |dscore| = {err:.3g}')
        assert err <= ATOL_SCORE
        # a batch row is the same chunk scored alone
        np.testing.assert_allclose(got[i, :n], tclf.predict(wavs[i]),
                                   atol=1e-5)


def test_classifier_embed_and_wire_formats(classifiers, bundle):
    jclf, tclf = classifiers
    wav = _wave(5.0, seed=3)
    np.testing.assert_allclose(tclf.embed(wav), jclf.embed(wav),
                               atol=ATOL_EMBED)
    for wire in ('float32', 'mulaw'):
        j = JaxClassifier(bundle, transfer_dtype=wire)
        t = ChunkClassifier(bundle, device='cpu', transfer_dtype=wire)
        # the JAX side encodes in its native stage when built: float32
        # log1pf may round a half-way mu-law code the other way (+-1 code)
        tw, jw = t.to_wire(wav), j.to_wire(wav)
        assert tw.dtype == jw.dtype
        dw = np.abs(tw.astype(np.float64) - jw.astype(np.float64)).max()
        assert dw <= (0 if wire == 'float32' else 1)
        err = float(np.abs(t.predict(wav) - j.predict(wav)).max())
        print(f'{wire} wire: max |dscore| = {err:.3g}')
        assert err <= ATOL_SCORE


def test_unported_options_raise(bundle):
    """conv='xla' is the one classifier option left unported; the modes
    ported since (bf16, emulated HIGH, the fused log-mel) construct and
    resolve as the JAX package's conv='pallas' resolves them."""
    with pytest.raises(NotImplementedError, match="The XLA conv path"):
        ChunkClassifier(bundle, device='cpu', conv='xla')
    for kw, knobs in (
            ({'conv_precision': 'high'}, ('xla', 'high', 'high')),
            ({'frontend': 'pallas'}, ('pallas', 'highest', 'highest')),
            ({'compute_dtype': torch.bfloat16}, ('xla', 'highest', 'bf16'))):
        clf = ChunkClassifier(bundle, device='cpu', **kw)
        assert (clf.frontend, clf.conv_precision, clf.mode) == knobs
        assert clf.conv == 'pallas'
    clf = ChunkClassifier(bundle, device='cpu')
    with pytest.raises(NotImplementedError, match='resampling'):
        clf.predict_async(np.zeros(16000, np.float32), input_rate=44100)
