"""Bundle conversion in the port (``buzzdetect_torch/models/convert.py``,
``models/heads.init_head`` and the tools ``build_ensemble`` and
``import_reference_model``) against the JAX package's, on inputs the tests
build: Keras h5 files in the layouts of ``tests/test_convert_h5.py``, a TF
checkpoint of a dense head, a metrics CSV. Every array must be
bit-identical (max |port - reference| = 0, printed per case).
"""

import importlib
import json
import os

import numpy as np
import pytest

from buzzdetect_tpu.models import convert as jconvert
from buzzdetect_tpu.models import heads as jheads
from buzzdetect_torch.models import convert as tconvert
from buzzdetect_torch.models import heads as theads
from tests.test_convert_h5 import _reference_params, _write_keras2_h5
from tests.test_torch_writers import run_tool

CLASSES = ['ins_buzz', 'ambient_noise', 'human']
METRICS = """threshold,precision,sensitivity,fpr
-2.0,0.50,0.99,0.5
-1.0,0.70,0.90,0.3
1.0,0.95,0.50,0.02
"""


def _same_arrays(got, ref):
    """Bit-identical dicts of arrays; returns max |got - ref| (0)."""
    assert set(got) == set(ref)
    worst = 0.0
    for k in ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.dtype == r.dtype and g.shape == r.shape, k
        np.testing.assert_array_equal(g, r, err_msg=k)
        if g.size:
            worst = max(worst, float(np.abs(g.astype(np.float64) - r).max()))
    return worst


def _bundle(d):
    with np.load(os.path.join(d, 'model.npz')) as z:
        arrays = {k: z[k] for k in z.files}
    with open(os.path.join(d, 'config_model.json')) as f:
        return arrays, json.load(f)


@pytest.mark.parametrize('wrap,underscore', [
    (False, False), (True, False), (True, True)])
def test_keras_h5_import_matches_jax(tmp_path, wrap, underscore):
    """The three h5 layouts: the port reads the same arrays as the JAX
    package, and both read the known values back."""
    expected = _reference_params()
    path = str(tmp_path / 'yamnet.h5')
    _write_keras2_h5(path, expected, wrap_model_weights=wrap,
                     underscore_names=underscore)
    got = tconvert.yamnet_from_keras_h5(path)
    print(f'max |port - reference| = '
          f'{_same_arrays(got, jconvert.yamnet_from_keras_h5(path))}')
    _same_arrays(got, expected)


def test_separable_batchnorms_and_depthwise_transpose(tmp_path):
    """Each separable layer's two BatchNorms bind to their own conv, and
    the depthwise HWCM -> HWIO transpose moves data."""
    expected = _reference_params()
    path = str(tmp_path / 'yamnet.h5')
    _write_keras2_h5(path, expected)
    got = tconvert.yamnet_from_keras_h5(path)
    for key in ('layer4/depthwise_conv', 'layer4/pointwise_conv'):
        np.testing.assert_array_equal(got[f'{key}/bn_beta'],
                                      expected[f'{key}/bn_beta'])
    assert got['layer2/depthwise_conv/kernel'].shape == (3, 3, 1, 32)
    np.testing.assert_array_equal(got['layer2/depthwise_conv/kernel'],
                                  expected['layer2/depthwise_conv/kernel'])
    print('max |port - reference| = 0.0')


def test_init_head_matches_jax():
    for n_emb, n_cls, seed in ((1024, 13, 0), (1024, 2, 3), (16, 4, 7)):
        got = theads.init_head(n_emb, n_cls, seed=seed)
        worst = _same_arrays(got, jheads.init_head(n_emb, n_cls, seed=seed))
    print(f'max |port - reference| = {worst}')


def test_head_from_savedmodel_checkpoint_matches_jax(tmp_path):
    tf = pytest.importorskip('tensorflow')
    rng = np.random.default_rng(2)
    layer = tf.Module()
    layer.kernel = tf.Variable(rng.standard_normal((1024, 3))
                               .astype(np.float32))
    layer.bias = tf.Variable(rng.standard_normal(3).astype(np.float32))
    prefix = tf.train.Checkpoint(**{'layer_with_weights-0': layer}).write(
        str(tmp_path / 'variables' / 'variables'))
    got = tconvert.head_from_savedmodel_checkpoint(prefix)
    print(f'max |port - reference| = '
          f'{_same_arrays(got, jconvert.head_from_savedmodel_checkpoint(prefix))}')
    np.testing.assert_array_equal(got['head/kernel'], layer.kernel.numpy())


@pytest.mark.parametrize('sources', ['seeded', 'h5+metrics'])
def test_build_model_bundle_matches_jax(tmp_path, sources):
    kw = {'seed': 5}
    if sources != 'seeded':
        _write_keras2_h5(str(tmp_path / 'yamnet.h5'), _reference_params())
        (tmp_path / 'metrics.csv').write_text(METRICS)
        kw.update(yamnet_h5=str(tmp_path / 'yamnet.h5'),
                  metrics_csv=str(tmp_path / 'metrics.csv'))
    ref = jconvert.build_model_bundle(str(tmp_path / 'jax'), CLASSES, **kw)
    got = tconvert.build_model_bundle(str(tmp_path / 'port'), CLASSES, **kw)
    print(f'max |port - reference| = {_same_arrays(got[0], ref[0])}')
    assert got[1] == ref[1]
    _same_arrays(_bundle(tmp_path / 'port')[0], _bundle(tmp_path / 'jax')[0])
    assert _bundle(tmp_path / 'port')[1] == _bundle(tmp_path / 'jax')[1]
    arrays, config = tconvert.load_bundle(str(tmp_path / 'jax'))
    _same_arrays(arrays, ref[0])
    assert config == ref[1]


def test_missing_named_sources_raise(tmp_path):
    for kw in ({'yamnet_h5': str(tmp_path / 'no.h5')},
               {'head_checkpoint_prefix': str(tmp_path / 'no')},
               {'metrics_csv': str(tmp_path / 'no.csv')}):
        for convert in (jconvert, tconvert):
            with pytest.raises(FileNotFoundError, match='explicitly'):
                convert.build_model_bundle(str(tmp_path / 'm'), CLASSES,
                                           **kw)
    print('max |port - reference| = 0.0 (both raise)')


def test_metrics_from_csv_matches_jax(tmp_path):
    (tmp_path / 'm.csv').write_text(METRICS)
    (tmp_path / 'one.csv').write_text(METRICS.splitlines()[0] + '\n'
                                      + METRICS.splitlines()[1] + '\n')
    for name in ('m.csv', 'one.csv'):
        path = str(tmp_path / name)
        got = tconvert.metrics_from_csv(path)
        worst = _same_arrays(got, jconvert.metrics_from_csv(path))
        assert all(v.ndim == 1 for v in got.values())
    print(f'max |port - reference| = {worst}')


def _members(tmp_path):
    for name, seed_head in (('model_a', 1), ('model_b', 2)):
        tconvert.build_model_bundle(str(tmp_path / name), ['x', 'y'],
                                    seed=0)
        arrays, config = tconvert.load_bundle(str(tmp_path / name))
        arrays.update(theads.init_head(1024, 2, seed=seed_head))
        tconvert.save_bundle(str(tmp_path / name), arrays, config)
    return [str(tmp_path / 'model_a'), str(tmp_path / 'model_b')]


def test_build_ensemble_bundle_matches_jax(tmp_path):
    members = _members(tmp_path)
    ref = jconvert.build_ensemble_bundle(members, str(tmp_path / 'ens_j'))
    got = tconvert.build_ensemble_bundle(members, str(tmp_path / 'ens_t'))
    print(f'max |port - reference| = {_same_arrays(got[0], ref[0])}')
    assert got[1] == ref[1]
    assert got[1]['classes'] == ['model_a.x', 'model_a.y', 'model_b.x',
                                 'model_b.y']
    # mismatched embedders and one-member ensembles raise in both
    other = tmp_path / 'model_c'
    tconvert.build_model_bundle(str(other), ['z'], seed=9)
    for convert in (jconvert, tconvert):
        with pytest.raises(ValueError, match='different embedder'):
            convert.build_ensemble_bundle(members + [str(other)],
                                          str(tmp_path / 'bad'))
        with pytest.raises(ValueError, match='at least two'):
            convert.build_ensemble_bundle(members[:1], str(tmp_path / 'bad'))


def test_build_ensemble_tool_matches_jax(tmp_path):
    members = _members(tmp_path)
    outs = {}
    for pkg in ('buzzdetect_tpu', 'buzzdetect_torch'):
        out = str(tmp_path / f'ens_{pkg}')
        code, stdout, err = run_tool(pkg, 'build_ensemble',
                                     members + ['--out', out])
        assert code == 0, err
        outs[pkg] = (_bundle(out), stdout.replace(out, '<out>'))
    (got, got_out), (ref, ref_out) = outs['buzzdetect_torch'], \
        outs['buzzdetect_tpu']
    print(f'max |port - reference| = {_same_arrays(got[0], ref[0])}')
    assert got[1] == ref[1] and got_out == ref_out


def test_import_reference_model_tool_matches_jax(tmp_path, monkeypatch):
    """The tool on a reference checkout the test builds (a TF checkpoint
    of a 1024 x 13 head and a metrics table): bundles, metrics CSV and
    metrics SVG identical; then --card-only rewrites the card alone."""
    tf = pytest.importorskip('tensorflow')
    import matplotlib
    monkeypatch.setenv('SOURCE_DATE_EPOCH', '0')
    monkeypatch.setitem(matplotlib.rcParams, 'svg.hashsalt', 'buzz')
    ref_model = tmp_path / 'reference' / 'models' / 'model_general_v3'
    (ref_model / 'tests').mkdir(parents=True)
    (ref_model / 'tests' / 'metrics.csv').write_text(METRICS)
    layer = tf.Module()
    rng = np.random.default_rng(4)
    layer.kernel = tf.Variable(rng.standard_normal((1024, 13))
                               .astype(np.float32))
    layer.bias = tf.Variable(np.zeros(13, np.float32))
    tf.train.Checkpoint(**{'layer_with_weights-0': layer}).write(
        str(ref_model / 'variables' / 'variables'))
    outs = {}
    for pkg in ('buzzdetect_tpu', 'buzzdetect_torch'):
        out = tmp_path / f'out_{pkg}'
        code, _stdout, err = run_tool(
            pkg, 'import_reference_model',
            ['--reference', str(tmp_path / 'reference'), '--out', str(out)])
        assert code == 0, err
        card = run_tool(pkg, 'import_reference_model',
                        ['--card-only', '--out', str(out)])
        assert card[0] == 0, card[2]
        files = {}
        for f in ('tests/metrics.csv', 'tests/metrics.svg'):
            with open(out / f, 'rb') as fh:
                files[f] = fh.read()
        outs[pkg] = (_bundle(out), files)
    (got, got_files), (ref, ref_files) = outs['buzzdetect_torch'], \
        outs['buzzdetect_tpu']
    print(f'max |port - reference| = {_same_arrays(got[0], ref[0])}')
    assert got[1] == ref[1] and got_files == ref_files
    np.testing.assert_array_equal(got[0]['head/kernel'], layer.kernel.numpy())
    # the port asks for the reference checkout instead of assuming a path
    assert run_tool('buzzdetect_torch', 'import_reference_model',
                    ['--out', str(tmp_path / 'x')])[0] == 2


def test_convert_imports_no_tensorflow_or_h5py():
    """The readers import tensorflow and h5py only when called, so a
    machine without them still builds bundles."""
    import subprocess
    import sys
    code = ('import sys, buzzdetect_torch.models.convert as c\n'
            'c.build_model_bundle\n'
            'bad = [m for m in ("tensorflow", "h5py") if m in sys.modules]\n'
            'assert not bad, bad\n')
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, '-c', code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    importlib.import_module('buzzdetect_torch.models.convert')
    print('max |port - reference| = 0.0 (import check)')
