"""tests/test_classifier.py, case for case, against ``buzzdetect_torch``
(import prefix changed, same assertions, every model on ``device='cpu'``:
the module's ``ChunkClassifier``, ``load_model`` and ``Analyzer`` pass it).
Edits, each case's docstring says which:

* compile buckets: PyTorch runs eagerly and the port has no
  ``_compiled_lengths``; the padding and score assertions stay;
* ``conv_mxu_precision`` returns the names of ``jax.lax.Precision`` in
  lower case;
* conv ``'auto'`` resolves to the hand kernels (``'pallas'``, their plain
  versions on the CPU), so the auto precision is ``'highest'``; the case
  where HIGH and HIGHEST must agree bit for bit runs ``conv='xla'``, where
  both are exact f32 (on the kernels ``'high'`` is the emulated HIGH);
* the compilation cache: the port's counterpart is the kernel build cache
  (``ops/_build.library_path``), keyed by the sources and the flags, which
  name the target architecture;
* the export cases load the artifact on the CPU and hold it against the
  live classifier's scores (the JAX case calls ``_classify_padded``);
* the TF-oracle cases use the JAX package's Keras builder
  (``tests/test_yamnet.py``) on the same weights.

The JAX package's docstring:
End-to-end classifier tests: bundle loading, registry resolution, shape
bucketing, and full-pipeline score parity vs a TF composition of the same
weights (the BASELINE.md 1e-3 contract, waveform in -> scores out).
"""

import json
import os

import numpy as np
import pytest

import torch

from buzzdetect_torch.models import classifier as clf_mod
from buzzdetect_torch.models import registry
from buzzdetect_torch.models import yamnet as yam
from buzzdetect_torch.models.convert import build_model_bundle
from buzzdetect_torch.models.heads import init_head
from buzzdetect_torch.models.registry import load_embedder, BundleModel
from tests.test_reference_equivalence import TESTBUZZ

RNG = np.random.default_rng(1)
# the reference snapshot's root, where it is mounted
REFERENCE = os.path.dirname(os.path.dirname(TESTBUZZ))


def ChunkClassifier(arrays, **kw):
    """The port's ChunkClassifier, on the CPU."""
    kw.setdefault('device', 'cpu')
    return clf_mod.ChunkClassifier(arrays, **kw)


def load_model(modelname, **kw):
    """The port's load_model, on the CPU."""
    kw.setdefault('device', 'cpu')
    return registry.load_model(modelname, **kw)


def Analyzer(**kw):
    """The port's Analyzer, on the CPU."""
    from buzzdetect_torch import analysis
    kw.setdefault('device', 'cpu')
    return analysis.Analyzer(**kw)


@pytest.fixture(scope='module')
def bundle_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp('models') / 'testmodel'
    build_model_bundle(str(d), classes=['a', 'ins_buzz', 'c'], seed=5)
    return str(d)


@pytest.fixture(scope='module')
def arrays(bundle_dir):
    with np.load(os.path.join(bundle_dir, 'model.npz')) as z:
        return {k: z[k] for k in z.files}


def test_bundle_config(bundle_dir):
    with open(os.path.join(bundle_dir, 'config_model.json')) as f:
        config = json.load(f)
    assert config['classes'] == ['a', 'ins_buzz', 'c']
    assert config['n_embeddings'] == 1024
    assert 'seeded init' in config['provenance']


def test_classifier_shapes_and_bucketing(arrays):
    """The port runs eagerly: no compile buckets (``_compiled_lengths``) to
    count; the pad rule and the scores under padding are checked."""
    clf = ChunkClassifier(arrays, framehop_prop=1.0)
    wav = (RNG.standard_normal(int(4.8 * 16000)) * 0.1).astype(np.float32)
    out = clf.predict(wav)
    assert out.shape == (5, 3)

    # a shorter chunk pads to the same patch count (pad-and-mask)
    out2 = clf.predict(wav[:int(3.9 * 16000)])
    assert out2.shape == (5, 3) or out2.shape[0] == 5  # 3.9s -> 5 patches (pad rule)

    # padding must not change the scores of patches fully inside the audio
    # (the final patch sees zero-padding instead of the next chunk's samples —
    # reference chunking behaves identically)
    out3 = clf.predict(wav[:int(2.88 * 16000)])
    assert out3.shape == (3, 3)
    np.testing.assert_allclose(out3[:2], out[:2], atol=1e-4)


def test_registry_loads_bundle(bundle_dir, monkeypatch):
    from buzzdetect_torch import config as cfg
    monkeypatch.setattr(cfg, 'DIR_MODELS', os.path.dirname(bundle_dir))
    model = load_model('testmodel', framehop_prop=1.0, initialize=True)
    assert isinstance(model, BundleModel)
    assert model.config['classes'][1] == 'ins_buzz'
    assert model.embedder.framelength_s == 0.96
    assert model.embedder.framehop_s == 0.96
    # 1.0 s pads to one patch plus one hop (the reference pad rule) -> 2 patches
    out = model.predict(np.zeros(16000, np.float32))
    assert out.shape == (2, 3)


def test_registry_python_plugin(tmp_path, monkeypatch):
    """Drop-in model.py plugin directory, as in the reference plugin system."""
    from buzzdetect_torch import config as cfg
    d = tmp_path / 'models' / 'plugmodel'
    d.mkdir(parents=True)
    (d / 'config_model.json').write_text(json.dumps(
        {'classes': ['x', 'y'], 'embeddername': 'yamnet', 'digits_results': 2}))
    (d / 'model.py').write_text(
        'import numpy as np\n'
        'from buzzdetect_torch.models.registry import BaseModel\n\n'
        'class PlugModel(BaseModel):\n'
        '    modelname = "plugmodel"\n'
        '    def initialize(self):\n'
        '        pass\n'
        '    def predict(self, samples):\n'
        '        return np.zeros((1, 2))\n')
    monkeypatch.setattr(cfg, 'DIR_MODELS', str(tmp_path / 'models'))
    model = load_model('plugmodel', initialize=True)
    assert model.predict(None).shape == (1, 2)


def test_embedder_aliases():
    e1 = load_embedder('yamnet', 0.5)
    e2 = load_embedder('yamnet_k2', 0.5)
    assert type(e1) is type(e2)
    assert e1.framehop_s == pytest.approx(0.48)
    with pytest.raises(FileNotFoundError):
        load_embedder('nope')


def test_conv_precision_mapping():
    """The product knob -> MXU emulation depth rule (yamnet.conv_mxu_precision):
    f32 picks 6-pass HIGHEST (--strict_f32 oracle) or 3-pass HIGH (the
    default); bf16 operands always run 1-pass DEFAULT — emulation depth is
    meaningless when the operands are already bf16. The port names each
    ``jax.lax.Precision`` in lower case."""
    assert yam.conv_mxu_precision(torch.float32, 'highest') == 'highest'
    assert yam.conv_mxu_precision(torch.float32, 'high') == 'high'
    assert yam.conv_mxu_precision(torch.bfloat16, 'highest') == 'default'
    assert yam.conv_mxu_precision(torch.bfloat16, 'high') == 'default'
    with pytest.raises(ValueError, match='conv_precision'):
        yam.conv_mxu_precision(torch.float32, 'medium')
    # validation precedes the dtype short-circuit: a typo'd knob fails
    # loudly on the bf16 path too, not only when f32 happens to run
    with pytest.raises(ValueError, match='conv_precision'):
        yam.conv_mxu_precision(torch.bfloat16, 'hihgest')


def test_classifier_conv_precision_resolution(arrays):
    """'auto' resolves PER CONV PATH (round-5 real-bundle measurements):
    'high' on the XLA path (1.166x at 7.3-8.5e-4 — inside the 1e-3
    budget; the path mesh runs and pallas fallbacks take) but 'highest'
    on the pallas path (Mosaic refuses native HIGH; the in-kernel
    emulation measures ~1e-2 real-bundle deviation — over budget and
    dominated by --bf16). 'highest' stays the strict escape; anything
    else fails loudly. In the port conv auto resolves to the hand kernels,
    so its precision auto is 'highest'; 'xla' resolves to 'high'."""
    assert ChunkClassifier(arrays).conv == 'pallas'
    assert ChunkClassifier(arrays).conv_precision == 'highest'
    assert ChunkClassifier(arrays, conv='xla').conv_precision == 'high'
    # explicit pallas: precision auto stays at the exact-f32 oracle
    assert ChunkClassifier(
        arrays, conv='pallas').conv_precision == 'highest'
    # explicit values always win
    assert ChunkClassifier(
        arrays, conv_precision='highest').conv_precision == 'highest'
    assert ChunkClassifier(
        arrays, conv='pallas', conv_precision='high').conv_precision == 'high'
    with pytest.raises(ValueError, match='conv_precision'):
        ChunkClassifier(arrays, conv_precision='exact')


def test_conv_precision_threads_to_identical_scores_on_cpu(arrays):
    """On the CPU backend HIGH and HIGHEST are the same true-f32 matmul,
    so the knob must not change scores AT ALL here — this pins that the
    threading reaches the graph without perturbing anything else. (The
    on-chip deviation/therapy numbers live in docs/tuning.md; CPU cannot
    measure them.) The port's XLA conv path runs both as exact f32, as the
    JAX case's CPU default does; on the hand kernels 'high' is the emulated
    HIGH (``test_torch_pallas_conv.py``)."""
    wav = (RNG.standard_normal(32000) * 0.1).astype(np.float32)
    out_high = ChunkClassifier(arrays, conv='xla',
                               conv_precision='high').predict(wav)
    out_strict = ChunkClassifier(
        arrays, conv='xla', conv_precision='highest').predict(wav)
    np.testing.assert_array_equal(out_high, out_strict)


def test_strict_f32_threads_through_bundle_model(bundle_dir, monkeypatch):
    from buzzdetect_torch import config as cfg
    monkeypatch.setattr(cfg, 'DIR_MODELS', os.path.dirname(bundle_dir))
    """The port's auto precision is 'highest' on the kernels and 'high' on
    the XLA conv path; an explicit 'highest' threads through either."""
    m = load_model('testmodel', initialize=True, conv_precision='highest',
                   conv='xla')
    assert m.classifier.conv_precision == 'highest'
    m2 = load_model('testmodel', initialize=True, conv='xla')
    assert m2.classifier.conv_precision == 'high'
    assert load_model('testmodel', initialize=True
                      ).classifier.conv_precision == 'highest'


def _write_embedder_plugin(tmp_path, monkeypatch, lookahead_expr):
    from buzzdetect_torch import config as cfg
    d = tmp_path / 'embedders' / 'plugemb'
    d.mkdir(parents=True, exist_ok=True)
    (d / 'embedder.py').write_text(
        'from buzzdetect_torch.models.registry import BaseEmbedder\n\n'
        'class PlugEmbedder(BaseEmbedder):\n'
        '    embeddername = "plugemb"\n'
        '    framelength_s = 0.5\n'
        '    digits_time = 2\n'
        '    samplerate = 16000\n'
        '    n_embeddings = 8\n'
        f'    lookahead_s = {lookahead_expr}\n'
        '    def initialize(self):\n'
        '        pass\n'
        '    def embed(self, samples):\n'
        '        return None\n')
    monkeypatch.setattr(cfg, 'DIR_EMBEDDERS', str(tmp_path / 'embedders'))


def test_plugin_negative_lookahead_rejected_at_load(tmp_path, monkeypatch):
    """A plugin declaring a negative lookahead_s would silently shrink
    watch mode's demotion margin below the patch window (the baked-padded
    -row bug the attribute exists to prevent) — the registry rejects it at
    load time, pointing at the contract."""
    _write_embedder_plugin(tmp_path, monkeypatch, '-0.1')
    with pytest.raises(ValueError, match='lookahead_s must be >= 0'):
        load_embedder('plugemb')


def test_plugin_nan_lookahead_rejected_at_load(tmp_path, monkeypatch):
    _write_embedder_plugin(tmp_path, monkeypatch, 'float("nan")')
    with pytest.raises(ValueError, match='lookahead_s must be >= 0'):
        load_embedder('plugemb')


def test_plugin_oversized_lookahead_warns(tmp_path, monkeypatch):
    """lookahead_s past a full framelength is legal (extra-conservative
    demotion) but almost always a unit mistake — warn, don't block."""
    import warnings as _w
    _write_embedder_plugin(tmp_path, monkeypatch, '2.0')
    with pytest.warns(RuntimeWarning, match='exceeds framelength_s'):
        emb = load_embedder('plugemb')
    assert emb.lookahead_s == 2.0  # honored, not clamped

    # a tight declaration loads silently
    _write_embedder_plugin(tmp_path, monkeypatch, '0.02')
    with _w.catch_warnings():
        _w.simplefilter('error')
        assert load_embedder('plugemb').lookahead_s == 0.02


def test_full_pipeline_parity_vs_tf(arrays):
    """waveform -> scores: JAX fused graph vs TF composition of identical
    weights (tf.signal frontend + Keras CNN + dense head), atol 1e-3."""
    tf = pytest.importorskip('tensorflow')
    from tests.test_yamnet import _build_keras_yamnet
    from buzzdetect_torch.ops.frontend import FrontendConfig, pad_waveform

    cfg_fe = FrontendConfig().with_framehop(1.0)
    wav = (RNG.standard_normal(int(2.1 * 16000)) * 0.2).astype(np.float32)

    clf = ChunkClassifier(arrays, framehop_prop=1.0)
    ours = clf.predict(wav)
    _against_jax(ours, arrays, 1.0, wav)

    # TF oracle
    raw = {k.split('/', 1)[1]: v for k, v in arrays.items()
           if k.startswith('yamnet_raw/')}
    keras_model = _build_keras_yamnet(raw)
    padded = np.asarray(pad_waveform(wav, cfg_fe))
    stft = tf.signal.stft(tf.constant(padded, tf.float32), 400, 160, 512)
    mel = tf.signal.linear_to_mel_weight_matrix(64, 257, 16000, 125.0, 7500.0)
    log_mel = tf.math.log(tf.matmul(tf.abs(stft), mel) + 0.001)
    patches = tf.signal.frame(log_mel, 96, 96, axis=0)[..., None]
    emb = keras_model(patches, training=False).numpy()
    theirs = emb @ arrays['head/kernel'] + arrays['head/bias']

    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, atol=1e-3)


def _against_jax(ours, arrays, framehop, wav):
    """Print max |port - JAX| for the JAX classifier on the same input, and
    hold it to the 1e-3 budget."""
    from buzzdetect_tpu.models.classifier import ChunkClassifier as JClf
    ref = JClf(arrays, framehop_prop=framehop).predict(wav)
    print(f'framehop {framehop}: max |port - JAX| = '
          f'{np.abs(ours - ref).max():.3g}')
    np.testing.assert_allclose(ours, ref, atol=1e-3)


def test_head_import_from_reference_checkpoint():
    """The trained head weights must round-trip from the reference SavedModel."""
    pytest.importorskip('tensorflow')
    prefix = os.path.join(REFERENCE, 'models', 'model_general_v3',
                          'variables', 'variables')
    if not os.path.exists(prefix + '.index'):
        pytest.skip('reference checkpoint not mounted')
    from buzzdetect_torch.models.convert import head_from_savedmodel_checkpoint
    head = head_from_savedmodel_checkpoint(prefix)
    assert head['head/kernel'].shape == (1024, 13)
    assert head['head/bias'].shape == (13,)
    assert np.abs(head['head/kernel']).max() > 0  # real trained values


def test_aot_export_roundtrip(bundle_dir, monkeypatch, tmp_path):
    """The serialized serving artifact (``classify.pt2``, loaded on the
    CPU) reproduces live scores (the live classifier's ``predict`` on the
    same full-length wire, where the JAX case calls ``_classify_padded``)."""
    from buzzdetect_torch import config as cfg
    from buzzdetect_torch.models.export import (export_classifier,
                                                save_exported, load_exported)

    monkeypatch.setattr(cfg, 'DIR_MODELS', os.path.dirname(bundle_dir))
    blob, meta = export_classifier('testmodel', chunk_seconds=2.0,
                                   platforms=('cpu',))
    d = save_exported(str(tmp_path / 'serving'), blob, meta)

    call, meta2 = load_exported(d, device='cpu')
    assert meta2['classes'] == ['a', 'ins_buzz', 'c']

    wav = (RNG.standard_normal(meta2['input_samples'])
           * 20000).astype(np.int16)
    out = np.asarray(call(wav))

    model = load_model('testmodel', framehop_prop=1.0, initialize=True)
    live = model.classifier
    ref = live.predict(wav)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_export_conv_precision_resolution(bundle_dir, monkeypatch,
                                          tmp_path):
    """The export resolves conv_precision against ITS OWN conv path (not
    the build host's auto-resolved live path) — but an EXPLICIT pin in
    the bundle's config_model.json survives into the artifact, like the
    bundle's frontend/compute pins do."""
    import json as _json
    import shutil
    from buzzdetect_torch import config as cfg
    from buzzdetect_torch.models.export import export_classifier

    monkeypatch.setattr(cfg, 'DIR_MODELS', os.path.dirname(bundle_dir))
    # default bundle: the per-path rule applies to the export's conv
    _, meta = export_classifier('testmodel', chunk_seconds=2.0,
                                platforms=('cpu',), conv='xla')
    assert meta['conv_precision'] == 'high'
    # explicit export argument wins
    _, meta = export_classifier('testmodel', chunk_seconds=2.0,
                                platforms=('cpu',), conv='xla',
                                conv_precision='highest')
    assert meta['conv_precision'] == 'highest'

    # a bundle that PINS conv_precision keeps its pin in the artifact
    pinned = tmp_path / 'models' / 'pinnedmodel'
    shutil.copytree(bundle_dir, pinned)
    cfg_path = pinned / 'config_model.json'
    conf = _json.loads(cfg_path.read_text())
    conf['conv_precision'] = 'highest'
    cfg_path.write_text(_json.dumps(conf))
    monkeypatch.setattr(cfg, 'DIR_MODELS', str(tmp_path / 'models'))
    _, meta = export_classifier('pinnedmodel', chunk_seconds=2.0,
                                platforms=('cpu',), conv='xla')
    assert meta['conv_precision'] == 'highest'


def test_aot_export_slices_phantom_padding_row(bundle_dir, monkeypatch,
                                               tmp_path):
    """At framehop_prop > 1 the padded graph emits an extra pure-padding
    patch; load_exported must slice to n_patches like the live predict()
    path (regression: consumers scored a phantom patch of silence past the
    end of every chunk)."""
    from buzzdetect_torch import config as cfg
    from buzzdetect_torch.models.export import (export_classifier,
                                                save_exported, load_exported)
    from buzzdetect_torch.ops.frontend import (FrontendConfig, num_patches,
                                               padded_length)

    monkeypatch.setattr(cfg, 'DIR_MODELS', os.path.dirname(bundle_dir))
    blob, meta = export_classifier('testmodel', chunk_seconds=4.0,
                                   framehop_prop=2.0, platforms=('cpu',))
    # precondition: these settings really do pad in an extra patch — the
    # test is vacuous otherwise
    fcfg = FrontendConfig().with_framehop(2.0)
    n_samples = round(4.0 / 0.96) * int(round(0.96 * 16000))
    assert num_patches(padded_length(n_samples, fcfg), fcfg) \
        > meta['n_patches']

    call, meta2 = load_exported(save_exported(str(tmp_path / 's'), blob,
                                              meta), device='cpu')
    wav = (RNG.standard_normal(meta2['input_samples'])
           * 20000).astype(np.int16)
    out = np.asarray(call(wav))
    assert out.shape[0] == meta2['n_patches']


def test_full_pipeline_parity_vs_tf_halfhop(arrays):
    """Same waveform->scores parity check at framehop 0.5 (overlapping
    patches), the reference's yamnet_halfhop configuration."""
    tf = pytest.importorskip('tensorflow')
    from tests.test_yamnet import _build_keras_yamnet
    from buzzdetect_torch.ops.frontend import FrontendConfig, pad_waveform

    cfg_fe = FrontendConfig().with_framehop(0.5)
    wav = (RNG.standard_normal(int(3.1 * 16000)) * 0.2).astype(np.float32)

    clf = ChunkClassifier(arrays, framehop_prop=0.5)
    ours = clf.predict(wav)
    _against_jax(ours, arrays, 0.5, wav)

    raw = {k.split('/', 1)[1]: v for k, v in arrays.items()
           if k.startswith('yamnet_raw/')}
    keras_model = _build_keras_yamnet(raw)
    padded = np.asarray(pad_waveform(wav, cfg_fe))
    stft = tf.signal.stft(tf.constant(padded, tf.float32), 400, 160, 512)
    mel = tf.signal.linear_to_mel_weight_matrix(64, 257, 16000, 125.0, 7500.0)
    log_mel = tf.math.log(tf.matmul(tf.abs(stft), mel) + 0.001)
    patches = tf.signal.frame(log_mel, 96, 48, axis=0)[..., None]
    emb = keras_model(patches, training=False).numpy()
    theirs = emb @ arrays['head/kernel'] + arrays['head/bias']

    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, atol=1e-3)


def test_ensemble_bundle(tmp_path, monkeypatch):
    """Multi-head ensemble: one pass scores every member's classes, and each
    member's column block matches that member's own predictions."""
    import json
    from buzzdetect_torch import config as cfg_mod
    from buzzdetect_torch.models.convert import (build_model_bundle,
                                                 build_ensemble_bundle,
                                                 load_bundle, save_bundle)
    from buzzdetect_torch.models.heads import init_head

    dir_models = tmp_path / 'models'
    build_model_bundle(str(dir_models / 'ma'), classes=['x', 'y'], seed=5)
    # same embedder (same seed), different head
    build_model_bundle(str(dir_models / 'mb'), classes=['p', 'q', 'r'],
                       seed=5)
    arrays, config = load_bundle(str(dir_models / 'mb'))
    arrays.update(init_head(1024, 3, seed=77))
    save_bundle(str(dir_models / 'mb'), arrays, config)

    build_ensemble_bundle([str(dir_models / 'ma'), str(dir_models / 'mb')],
                          str(dir_models / 'ens'))
    ens_config = json.load(open(dir_models / 'ens' / 'config_model.json'))
    assert ens_config['classes'] == ['ma.x', 'ma.y', 'mb.p', 'mb.q', 'mb.r']

    monkeypatch.setattr(cfg_mod, 'DIR_MODELS', str(dir_models))
    wav = (np.random.default_rng(8).standard_normal(2 * 16000) * 0.1
           ).astype(np.float32)
    ens = load_model('ens', initialize=True).predict(wav)
    a = load_model('ma', initialize=True).predict(wav)
    b = load_model('mb', initialize=True).predict(wav)
    # 1e-6-level deviation: the wider concatenated kernel tiles the matmul
    # differently; scores round identically at the 2-decimal output digits
    np.testing.assert_allclose(ens[:, :2], a, atol=1e-5)
    np.testing.assert_allclose(ens[:, 2:], b, atol=1e-5)

    # mismatched embedders must refuse to merge
    build_model_bundle(str(dir_models / 'mc'), classes=['z'], seed=9)
    with pytest.raises(ValueError, match='different embedder'):
        build_ensemble_bundle([str(dir_models / 'ma'),
                               str(dir_models / 'mc')],
                              str(dir_models / 'bad'))


def test_bf16_activations_warns_detections_does_not(bundle_dir, monkeypatch):
    """compute_dtype=bfloat16 breaks the 1e-3 activations-parity contract
    (measured ~0.006 max deviation, docs/tuning.md): constructing an
    Analyzer in activations mode must warn; detections mode (insensitive at
    that deviation) must not."""
    import warnings
    from buzzdetect_torch import config as cfg
    from buzzdetect_torch import analysis as analysis_mod
    monkeypatch.setattr(cfg, 'DIR_MODELS', os.path.dirname(bundle_dir))

    with pytest.warns(UserWarning, match='bfloat16'):
        Analyzer(modelname='testmodel', compute_dtype=torch.bfloat16,
                 verbosity_print='ERROR')

    # detections mode: no bf16 warning (thresholds are insensitive; see
    # test_bf16_detections_insensitive_at_measured_deviation)
    monkeypatch.setattr(analysis_mod, 'calculate_threshold',
                        lambda modelname, precision: -1.2)
    with warnings.catch_warnings():
        warnings.simplefilter('error', UserWarning)
        Analyzer(modelname='testmodel', precision=0.95,
                 compute_dtype=torch.bfloat16, verbosity_print='ERROR')

    # f32 activations: no warning either
    with warnings.catch_warnings():
        warnings.simplefilter('error', UserWarning)
        Analyzer(modelname='testmodel', verbosity_print='ERROR')


def test_bf16_detections_insensitive_at_measured_deviation(arrays):
    """The claim behind the guardrail's 'detections mode is insensitive':
    any threshold that sits outside the bf16 noise margin of every score
    yields byte-identical 0/1 detections — and the measured deviation stays
    on the documented ~0.006 scale (a regression here would invalidate the
    warning text and docs/tuning.md)."""
    clf32 = ChunkClassifier(arrays, framehop_prop=1.0)
    clf16 = ChunkClassifier(arrays, framehop_prop=1.0,
                            compute_dtype=torch.bfloat16)
    wav = (RNG.standard_normal(int(4.8 * 16000)) * 0.2).astype(np.float32)
    a32 = clf32.predict(wav)
    a16 = clf16.predict(wav)
    dev = float(np.abs(a32 - a16).max())
    assert dev < 0.02, f'bf16 deviation {dev} far above the documented scale'

    s32, s16 = a32[:, 1], a16[:, 1]  # ins_buzz column
    thresholds = [t for t in np.linspace(s32.min() - 0.5, s32.max() + 0.5, 41)
                  if np.abs(s32 - t).min() > dev]
    assert len(thresholds) > 10  # the margin excludes only a sliver
    for thr in thresholds:
        np.testing.assert_array_equal(s32 > thr, s16 > thr)


def test_compilation_cache_partitioned_per_host():
    """The port compiles no XLA graphs; its persistent build cache is the
    kernel libraries' (``ops/_build.library_path``), built into the
    package's ``csrc/build/``. A cached library must never be loaded for
    another target: the key must be stable within a host and derive from
    the sources and the nvcc flags, which name the architecture
    (sm_90a)."""
    from buzzdetect_torch.ops import _build

    key = _build.library_path('sepconv')
    assert key == _build.library_path('sepconv')  # deterministic
    assert os.path.dirname(key) == _build.DIR_BUILD
    digest = os.path.basename(key)[len('libsepconv_'):-len('.so')]
    assert len(digest) == 16 and all(c in '0123456789abcdef'
                                     for c in digest)
    assert 'arch=compute_90a,code=sm_90a' in _build.NVCC_FLAGS
    flags = _build.NVCC_FLAGS
    try:
        _build.NVCC_FLAGS = [f.replace('90a', '80') for f in flags]
        assert _build.library_path('sepconv') != key
    finally:
        _build.NVCC_FLAGS = flags
