"""tests/test_yamnet.py, case for case, against ``buzzdetect_torch`` (import
prefix changed, same assertions, on the CPU). Edits: the port's functions
take tensors (``params_from_numpy`` lays the folded weights out for its
kernels; raw parameters and patches go in through ``torch.from_numpy``);
``embed`` runs the hand kernels' plain versions (the port's default
``conv='pallas'``), and the embed case also runs the JAX package's
``embed`` on the same input, printing max |port - JAX|; ``embed_train``
returns the updated BatchNorm statistics alone, not the whole parameter
dict.

The JAX package's docstring:
Golden-parity tests: JAX MobileNet/YAMNet embedder vs a TF-Keras model of
the published architecture carrying identical weights.

This validates the compute path (conv semantics, SAME padding, BN folding,
GAP, head) to the <=1e-3 budget independent of which pretrained weights are
installed: with identical weights, pipeline parity IS score parity.
"""

import numpy as np
import pytest

import torch

from buzzdetect_torch.models import yamnet as yam
from buzzdetect_torch.models.heads import init_head, apply_head
from buzzdetect_torch.models.weights import params_from_numpy

tf = pytest.importorskip('tensorflow')

RNG = np.random.default_rng(42)


def _build_keras_yamnet(raw_params):
    """The published YAMNet core (reference `embedders/yamnet/yamnet.py:77-106`)
    in Keras, loaded with our raw parameters."""
    from tensorflow.keras import layers

    inp = tf.keras.Input(shape=(96, 64, 1))
    x = inp
    in_ch = 1
    weight_sets = []
    for i, (kind, stride, filters) in enumerate(yam.LAYER_DEFS):
        name = f'layer{i + 1}'
        if kind == 'conv':
            conv = layers.Conv2D(filters, 3, strides=stride, padding='same',
                                 use_bias=False, name=f'{name}_conv')
            x = conv(x)
            bn = layers.BatchNormalization(center=True, scale=False,
                                           epsilon=yam.BN_EPSILON,
                                           name=f'{name}_conv_bn')
            x = bn(x)
            x = layers.ReLU()(x)
            weight_sets.append((f'{name}/conv', conv, bn, False))
        else:
            dconv = layers.DepthwiseConv2D(3, strides=stride, padding='same',
                                           use_bias=False,
                                           name=f'{name}_depthwise_conv')
            x = dconv(x)
            bn1 = layers.BatchNormalization(center=True, scale=False,
                                            epsilon=yam.BN_EPSILON)
            x = bn1(x)
            x = layers.ReLU()(x)
            weight_sets.append((f'{name}/depthwise_conv', dconv, bn1, True))
            pconv = layers.Conv2D(filters, 1, strides=1, padding='same',
                                  use_bias=False, name=f'{name}_pointwise_conv')
            x = pconv(x)
            bn2 = layers.BatchNormalization(center=True, scale=False,
                                            epsilon=yam.BN_EPSILON)
            x = bn2(x)
            x = layers.ReLU()(x)
            weight_sets.append((f'{name}/pointwise_conv', pconv, bn2, False))
        in_ch = filters

    out = layers.GlobalAveragePooling2D()(x)
    model = tf.keras.Model(inp, out)

    for key, conv, bn, depthwise in weight_sets:
        kernel = raw_params[f'{key}/kernel']
        if depthwise:
            kernel = np.transpose(kernel, (0, 1, 3, 2))  # HWIO -> Keras HWCM
        conv.set_weights([kernel])
        bn.set_weights([raw_params[f'{key}/bn_beta'],
                        raw_params[f'{key}/bn_mean'],
                        raw_params[f'{key}/bn_var']])
    return model


@pytest.fixture(scope='module')
def raw_params():
    p = yam.init_raw_params(seed=7)
    # non-trivial BN stats so folding is actually exercised
    rng = np.random.default_rng(3)
    for k in list(p):
        if k.endswith('bn_mean'):
            p[k] = rng.standard_normal(p[k].shape).astype(np.float32) * 0.1
        elif k.endswith('bn_var'):
            p[k] = (0.5 + rng.random(p[k].shape).astype(np.float32))
        elif k.endswith('bn_beta'):
            p[k] = rng.standard_normal(p[k].shape).astype(np.float32) * 0.1
    return p


def test_embed_matches_keras(raw_params):
    patches = RNG.standard_normal((4, 96, 64, 1)).astype(np.float32)

    keras_model = _build_keras_yamnet(raw_params)
    theirs = keras_model(patches, training=False).numpy()

    folded = yam.fold_batchnorm(raw_params)
    ours = np.asarray(yam.embed(params_from_numpy(folded)['yamnet'],
                                torch.from_numpy(patches)))

    assert ours.shape == theirs.shape == (4, 1024)
    np.testing.assert_allclose(ours, theirs, atol=1e-3)
    from buzzdetect_tpu.models import yamnet as jyam
    ref = np.asarray(jyam.embed(folded, patches))
    print(f'embed: max |port - JAX| = {np.abs(ours - ref).max():.3g}')
    np.testing.assert_allclose(ours, ref, atol=1e-3)
    # embeddings are post-ReLU means: non-negative, non-degenerate
    assert ours.min() >= 0
    assert ours.std() > 1e-4


def test_head_matches_dense(raw_params):
    head = init_head(1024, 13, seed=0)
    emb = RNG.standard_normal((8, 1024)).astype(np.float32)
    ours = np.asarray(apply_head({k: torch.from_numpy(v)
                                  for k, v in head.items()},
                                 torch.from_numpy(emb)))
    theirs = emb @ head['head/kernel'] + head['head/bias']
    np.testing.assert_allclose(ours, theirs, atol=1e-4)


def test_fold_batchnorm_identity_when_fresh():
    raw = yam.init_raw_params(seed=0)
    folded = yam.fold_batchnorm(raw)
    # fresh BN (mean 0, var 1): kernel scaled by 1/sqrt(1+eps), zero bias
    k = raw['layer1/conv/kernel']
    np.testing.assert_allclose(folded['layer1/conv/kernel'],
                               k / np.sqrt(1 + yam.BN_EPSILON), rtol=1e-6)
    np.testing.assert_allclose(folded['layer1/conv/bias'], 0, atol=1e-7)


def test_embed_train_updates_bn_stats(raw_params):
    patches = RNG.standard_normal((2, 96, 64, 1)).astype(np.float32)
    emb, new_params = yam.embed_train(
        {k: torch.from_numpy(v) for k, v in raw_params.items()},
        torch.from_numpy(patches))
    assert emb.shape == (2, 1024)
    # running stats moved toward the batch stats
    moved = np.abs(np.asarray(new_params['layer1/conv/bn_mean'])
                   - raw_params['layer1/conv/bn_mean']).max()
    assert moved > 0
