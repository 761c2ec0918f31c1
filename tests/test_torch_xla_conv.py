"""The port's XLA conv path (``conv='xla'``: ``yamnet.embed_xla``, every conv
a library ``F.conv2d``) against the JAX package's ``conv='xla'`` on the CPU,
from the embed on seeded weights up to whole-classifier scores on the real
model_general_v3 bundle.

On the CPU both sides compute exact f32 products: XLA ignores ``'high'``
there, and the port runs ``'high'`` and ``'highest'`` as exact f32 on every
device. Inputs are numpy with fixed seeds.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from buzzdetect_tpu import config as jcfg
from buzzdetect_tpu.models import yamnet as jyam
from buzzdetect_tpu.models.classifier import ChunkClassifier as JaxClassifier
from buzzdetect_torch.models import yamnet as tyam
from buzzdetect_torch.models.classifier import ChunkClassifier
from buzzdetect_torch.models.weights import params_from_numpy
from buzzdetect_torch.ops import frontend, sepconv

BUNDLE = os.path.join(jcfg.DIR_REPO, 'models', 'model_general_v3',
                      'model.npz')
# f32: the same exact-f32 products summed in another order
ATOL, RTOL = 2e-4, 1e-5
# bf16: the products are exact on both sides, but a one-ulp f32 difference
# in a sum before a layer rounds its output to bf16 can flip that output by
# one bf16 ulp (2^-8 relative); bound: 4 ulps of the largest value plus 2
# ulps relative, as tests/test_torch_precision_modes.py bounds the kernels'
ULP_BF16 = 2.0 ** -8
# scores: the BASELINE.md parity budget (f32) and the bf16 fault threshold
ATOL_SCORE = 1e-3
BF16_SCORE_FAULT = 5e-3

CASES = {  # case -> (JAX compute dtype, port compute dtype, precision)
    'f32-high': (jnp.float32, torch.float32, 'high'),
    'f32-highest': (jnp.float32, torch.float32, 'highest'),
    'bf16': (jnp.bfloat16, torch.bfloat16, 'high'),
}


@pytest.fixture(scope='module')
def bundle():
    with np.load(BUNDLE) as z:
        return {k: z[k] for k in z.files}


def _folded(bundle):
    """The bundle's embedder weights (stored raw), BatchNorm folded by the
    JAX package."""
    return jyam.fold_batchnorm({k.split('/', 1)[1]: v
                                for k, v in bundle.items()
                                if k.startswith('yamnet_raw/')})


def _check(name, case, got, ref):
    err = float(np.abs(got - ref).max())
    if case == 'bf16':
        atol, rtol = 4 * ULP_BF16 * float(np.abs(ref).max()), 2 * ULP_BF16
    else:
        atol, rtol = ATOL, RTOL
    print(f'{name} [{case}]: max |port - JAX| = {err:.3g} (atol {atol:.3g}, '
          f'rtol {rtol:.3g})')
    np.testing.assert_allclose(got, ref, atol=atol, rtol=rtol)


def _embeds(folded, patches, case):
    jdt, tdt, precision = CASES[case]
    ref = np.asarray(jyam.embed(
        {k: jnp.asarray(v) for k, v in folded.items()}, jnp.asarray(patches),
        jdt, 'xla', precision), np.float32)
    params = tyam.pack_xla(params_from_numpy(folded)['yamnet'], tdt)
    got = tyam.embed(params, torch.from_numpy(patches), tdt, precision,
                     conv='xla').numpy()
    assert got.shape == ref.shape == (patches.shape[0], 1024)
    assert got.dtype == np.float32
    return got, ref


@pytest.mark.parametrize('case', list(CASES))
def test_embed_xla_matches_jax_on_seeded_weights(case):
    """Seeded raw weights (BatchNorm folded on each side), seeded patches,
    a small batch."""
    folded = jyam.fold_batchnorm(jyam.init_raw_params(seed=9))
    patches = np.random.default_rng(2).standard_normal(
        (3, 96, 64)).astype(np.float32)
    got, ref = _embeds(folded, patches, case)
    _check('embed, seeded weights, B=3', case, got, ref)


@pytest.mark.parametrize('case', list(CASES))
def test_embed_xla_matches_jax_on_the_bundle(bundle, case):
    """The bundle's embedder at full width, on log-mel patches of 12.5 s of
    seeded audio (12 patches, with a (B, 96, 64, 1) input)."""
    folded = _folded(bundle)
    cfg = frontend.FrontendConfig()
    wav = np.random.default_rng(3).standard_normal(
        frontend.min_waveform_samples(cfg) + 11 * cfg.patch_hop_samples)
    patches = frontend.log_mel_patches(
        torch.from_numpy((wav * 0.1).astype(np.float32)), cfg).numpy()
    got, ref = _embeds(folded, patches[..., None], case)
    _check('embed, model_general_v3, B=12', case, got, ref)


def _wave(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    tone = 0.2 * np.sin(2 * np.pi * 330 * t) * (t % 2 < 1)
    return (tone + rng.standard_normal(len(t)) * 0.05).astype(np.float32)


@pytest.mark.parametrize('case', ['f32', 'bf16'])
def test_xla_scores_match_jax(bundle, case):
    """Whole-classifier scores on the real bundle against the JAX package's
    ChunkClassifier(conv='xla') at its 'auto' precision ('high'), int16
    wire. In bf16 the port's conv='xla' is the other bf16 function: it lies
    far from the port's own conv='pallas' bf16, as the JAX package's two
    do (ROADMAP §3 reads 0.106 on this bundle)."""
    jkw = {'compute_dtype': jnp.bfloat16} if case == 'bf16' else {}
    tkw = {'compute_dtype': torch.bfloat16} if case == 'bf16' else {}
    wav = _wave(7.7, seed=5)
    jclf = JaxClassifier(bundle, conv='xla', transfer_dtype='int16', **jkw)
    assert jclf.conv_precision == 'high'
    ref = jclf.predict(wav)
    tclf = ChunkClassifier(bundle, device='cpu', conv='xla',
                           transfer_dtype='int16', **tkw)
    assert (tclf.conv, tclf.conv_precision, tclf.mode) == (
        'xla', 'high', 'bf16' if case == 'bf16' else 'highest')
    got = tclf.predict(wav)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    budget = BF16_SCORE_FAULT if case == 'bf16' else ATOL_SCORE
    print(f'scores [{case}] conv=xla vs JAX conv=xla: max |dscore| = '
          f'{err:.3g} (budget {budget})')
    assert err <= budget
    if case == 'bf16':
        kernels = ChunkClassifier(bundle, device='cpu',
                                  transfer_dtype='int16', **tkw).predict(wav)
        apart = float(np.abs(got - kernels).max())
        print(f'port bf16 conv=xla vs port bf16 conv=pallas: max |dscore| '
              f'= {apart:.3g}')
        assert apart > 10 * BF16_SCORE_FAULT


def test_xla_path_never_reaches_the_conv_kernels(bundle, monkeypatch):
    """With conv='xla' neither the kernels' wrappers nor their plain
    versions run, on the single-chunk, batch and embed paths alike, with
    either frontend; the batch equals the single chunks bit for bit."""
    def refuse(*_a, **_k):
        raise AssertionError('conv=xla reached ops/sepconv.py')
    for name in ('fused_front', 'fused_tail', 'fused_front_plain',
                 'fused_tail_plain'):
        monkeypatch.setattr(sepconv, name, refuse)
    monkeypatch.setattr(tyam, 'fused_front', refuse)
    monkeypatch.setattr(tyam, 'fused_tail', refuse)
    wavs = [_wave(3.1, seed=7), _wave(5.0, seed=8)]
    for fe in ('xla', 'pallas'):
        clf = ChunkClassifier(bundle, device='cpu', conv='xla', frontend=fe)
        assert clf.frontend == fe
        single = [clf.predict(w) for w in wavs]
        out, n_valids = clf.predict_async_batch(wavs)
        for i, n in enumerate(n_valids):
            assert torch.equal(out[i, :n], torch.from_numpy(single[i]))
        assert clf.embed(wavs[0]).shape == (single[0].shape[0], 1024)


def test_pack_xla_layouts(bundle):
    """pack_xla lays out each conv for F.conv2d (OIHW) from the kernels'
    layouts, rounds to bf16 only under bf16 compute, and embed_xla refuses
    params it did not pack."""
    params = params_from_numpy(bundle)['yamnet']
    f32 = tyam.pack_xla(params, torch.float32)
    bf16 = tyam.pack_xla(params, 'bfloat16')
    folded = _folded(bundle)
    for key, kind, _stride, shape in tyam._conv_shapes():
        hwio = folded[f'{key}/kernel']
        oihw = torch.from_numpy(np.ascontiguousarray(
            hwio.transpose(3, 2, 0, 1)))
        if kind == 'depthwise':   # HWIO (3, 3, 1, C): C groups of one
            oihw = oihw.reshape(shape[3], 1, 3, 3)
        assert torch.equal(f32[f'{key}/kernel[xla]'], oihw), key
        assert torch.equal(bf16[f'{key}/kernel[xla-bf16]'],
                           sepconv.round_bf16(oihw)), key
    with pytest.raises(KeyError):
        tyam.embed_xla(params, torch.zeros(1, 96, 64))
