"""The plain reference against the port, on the CPU at a small size."""

import json
import os

import numpy as np
import pytest

from benchmark import checks, synth
from benchmark.reference import yamnet as ref

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BUNDLE = os.path.join(ROOT, 'models', 'model_general_v3', 'model.npz')
CONFIGS = [c['file'] for c in json.load(open(os.path.join(
    ROOT, 'BENCHMARK.json')))['configs']]


@pytest.fixture(scope='module')
def weights():
    return ref.load_bundle(BUNDLE, 'cpu')


def _port(compute_dtype, samples):
    from buzzdetect_torch.models.registry import load_model
    m = load_model('model_general_v3', device='cpu', transfer_dtype='int16',
                   compute_dtype=compute_dtype)
    m.initialize()
    out, n = m.predict_async(samples)
    return out.numpy()[:n]


@pytest.mark.parametrize('seconds', [2.0, 4.5])
def test_f32_reference_matches_the_port(weights, seconds):
    x = synth.recordings(3, 1, seconds)[0]
    want = _port('float32', x)
    got = ref.classify(weights, x, 'f32')
    assert got.shape == want.shape == (ref.n_patches(len(x)), 13)
    assert np.abs(got - want).max() < 3e-5


def test_bf16_reference_follows_the_port(weights):
    x = synth.recordings(4, 1, 3.0)[0]
    want = _port('bfloat16', x)
    assert np.abs(ref.classify(weights, x, 'bf16') - want).max() < 0.02
    # and the bf16 function is not the f32 one
    assert np.abs(ref.classify(weights, x, 'f32') - want).max() > 1e-3


def test_controls_depart_from_their_functions(weights):
    x = synth.recordings(5, 1, 3.0)[0]
    f32, tf32 = (ref.classify(weights, x, p) for p in ('f32', 'tf32'))
    bf16, fp8 = (ref.classify(weights, x, p) for p in ('bf16', 'fp8'))
    assert np.abs(tf32 - f32).max() > 1e-3
    assert np.abs(fp8 - bf16).max() > 0.05


def test_patch_counts_follow_the_port():
    from buzzdetect_torch.ops.frontend import (FrontendConfig, num_patches,
                                               padded_length)
    cfg = FrontendConfig().with_framehop(1.0)
    for n in (1, 15599, 15600, 15601, 480_000, 3_194_880, 3_200_000):
        assert ref.n_patches(n) == num_patches(n, cfg)
        assert ref.padded_samples(n) == padded_length(n, cfg)



@pytest.mark.parametrize('config', CONFIGS)
@pytest.mark.parametrize('seed', [11, 2 ** 33 + 5])
def test_the_default_reference_scores_as_the_bundle_did(weights, seed,
                                                        config):
    """A configuration that names no reference is judged by YAMNet's, bit
    for bit as the harness computed it before references had names: the
    bundle loaded, each chunk classified in the configuration's function."""
    config = json.load(open(os.path.join(ROOT, config)))
    assert 'reference' not in config
    inputs = dict(enumerate(synth.recordings(seed, 2, 2.5)))
    got = checks.reference_scores(config, inputs, 'cpu')
    assert sorted(got) == sorted(inputs)
    for k, x in inputs.items():
        want = ref.classify(weights, x, config['reference_function'])
        assert got[k].dtype == want.dtype
        assert np.array_equal(got[k], want)
