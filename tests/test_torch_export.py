"""The serving export of the port (``buzzdetect_torch/models/export.py``)
and the custom operators it records (``buzzdetect_torch/ops/library.py``),
on the CPU.

Mirrors ``tests/test_classifier.py::test_aot_export_roundtrip``,
``::test_export_conv_precision_resolution`` and
``::test_aot_export_slices_phantom_padding_row`` on ``device='cpu'``, and
holds the port's CPU artifact against the JAX package's CPU artifact of the
same bundle on the same seeded int16 wire (1e-4, max difference printed).
The ``conv='pallas'`` artifacts need the card (``chip_smoke.py`` phase 8);
here their refusal with ``'cpu'`` in ``platforms``, the operators' fake
implementations (the shapes a trace on the card sees) and their refusal of
CPU tensors are checked.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from buzzdetect_torch import config as cfg
from buzzdetect_torch.models.convert import build_model_bundle
from buzzdetect_torch.models.export import (export_classifier, load_exported,
                                            save_exported)
from buzzdetect_torch.models.registry import load_model
from buzzdetect_torch.ops import library, logmel, sepconv
from buzzdetect_torch.ops.frontend import FrontendConfig, padded_length

RNG = np.random.default_rng(1)
TOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def bundle_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp('models') / 'testmodel'
    build_model_bundle(str(d), classes=['a', 'ins_buzz', 'c'], seed=5)
    return str(d)


@pytest.fixture()
def models(bundle_dir, monkeypatch):
    monkeypatch.setattr(cfg, 'DIR_MODELS', os.path.dirname(bundle_dir))
    return os.path.dirname(bundle_dir)


def _wire(n):
    return (RNG.standard_normal(n) * 20000).astype(np.int16)


def test_aot_export_roundtrip(models, tmp_path):
    """The serialized serving artifact reproduces live scores."""
    blob, meta = export_classifier('testmodel', chunk_seconds=2.0,
                                   platforms=('cpu',))
    d = save_exported(str(tmp_path / 'serving'), blob, meta)
    assert sorted(os.listdir(d)) == ['classify.pt2', 'export_meta.json']

    call, meta2 = load_exported(d, device='cpu')
    assert meta2['classes'] == ['a', 'ins_buzz', 'c']
    assert (meta2['conv'], meta2['conv_precision']) == ('xla', 'high')

    wav = _wire(meta2['input_samples'])
    out = call(wav)
    model = load_model('testmodel', initialize=True, device='cpu',
                       conv=meta2['conv'],
                       conv_precision=meta2['conv_precision'])
    ref = model.classifier.predict(wav)
    print(f'max |artifact - live| = {np.abs(out - ref).max():.3g}')
    np.testing.assert_allclose(out, ref, atol=TOL)


def test_export_conv_precision_resolution(bundle_dir, models, tmp_path,
                                          monkeypatch):
    """The export resolves conv_precision against ITS OWN conv path (not
    the live model's auto-resolved path, 'highest' on the kernels) — but an
    EXPLICIT pin in the bundle's config_model.json survives into the
    artifact, like the bundle's frontend/compute pins do."""
    live = load_model('testmodel', initialize=True, device='cpu')
    assert live.classifier._conv_precision_auto
    assert live.classifier.conv_precision == 'highest'
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
    conf = json.loads(cfg_path.read_text())
    conf['conv_precision'] = 'highest'
    cfg_path.write_text(json.dumps(conf))
    monkeypatch.setattr(cfg, 'DIR_MODELS', str(tmp_path / 'models'))
    assert not load_model('pinnedmodel', initialize=True, device='cpu'
                          ).classifier._conv_precision_auto
    _, meta = export_classifier('pinnedmodel', chunk_seconds=2.0,
                                platforms=('cpu',), conv='xla')
    assert meta['conv_precision'] == 'highest'


def test_aot_export_slices_phantom_padding_row(models, tmp_path):
    """At framehop_prop > 1 the padded graph emits an extra pure-padding
    patch; load_exported must slice to n_patches like the live predict()
    path."""
    from buzzdetect_torch.ops.frontend import num_patches
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
    out = call(_wire(meta2['input_samples']))
    assert out.shape == (meta2['n_patches'], 3)


def test_port_artifact_matches_the_jax_artifact(bundle_dir, models,
                                                monkeypatch, tmp_path):
    """One bundle, exported for the CPU by both packages, scores one seeded
    int16 wire alike."""
    from buzzdetect_tpu import config as jax_cfg
    from buzzdetect_tpu.models import export as jax_export
    monkeypatch.setattr(jax_cfg, 'DIR_MODELS', os.path.dirname(bundle_dir))
    blob, meta = export_classifier('testmodel', chunk_seconds=4.0,
                                   platforms=('cpu',))
    jblob, jmeta = jax_export.export_classifier('testmodel',
                                                chunk_seconds=4.0,
                                                platforms=('cpu',))
    keys = ('classes', 'chunk_seconds', 'input_samples', 'input_dtype',
            'framehop_prop', 'framehop_s', 'n_patches', 'platforms', 'conv',
            'conv_precision', 'samplerate', 'modelname')
    assert {k: meta[k] for k in keys} == {k: jmeta[k] for k in keys}
    assert set(meta) == set(jmeta)
    call, _ = load_exported(save_exported(str(tmp_path / 'port'), blob,
                                          meta), device='cpu')
    jcall, _ = jax_export.load_exported(
        jax_export.save_exported(str(tmp_path / 'jax'), jblob, jmeta))
    wav = _wire(meta['input_samples'])
    port, ref = call(wav), np.asarray(jcall(wav))
    worst = float(np.abs(port - ref).max())
    print(f'max |port - jax| over artifact scores = {worst:.3g}')
    assert port.shape == ref.shape == (meta['n_patches'], 3)
    assert worst <= TOL


def test_mulaw_wire_round_trips(models, tmp_path):
    """A mulaw artifact takes the int8 wire and scores as the live mulaw
    model does."""
    blob, meta = export_classifier('testmodel', chunk_seconds=2.0,
                                   platforms=('cpu',),
                                   transfer_dtype='mulaw')
    assert meta['input_dtype'] == 'mulaw'
    call, meta2 = load_exported(save_exported(str(tmp_path / 'mu'), blob,
                                              meta), device='cpu')
    model = load_model('testmodel', initialize=True, device='cpu',
                       transfer_dtype='mulaw', conv='xla',
                       conv_precision=meta2['conv_precision'])
    wav = (RNG.standard_normal(meta2['input_samples']) * 0.2
           ).astype(np.float32)
    wire = model.classifier.to_wire(wav)
    assert wire.dtype == np.int8
    np.testing.assert_allclose(call(wire), model.classifier.predict(wire),
                               atol=TOL)
    with pytest.raises(TypeError, match='int8'):
        call(wire.astype(np.int16))
    with pytest.raises(ValueError, match='samples'):
        call(wire[:-1])


@pytest.mark.parametrize('kw', [{'conv': 'pallas'},
                                {'conv': 'pallas', 'platforms': ('cpu',)},
                                {'frontend': 'pallas'}])
def test_kernel_exports_refuse_the_cpu(bundle_dir, tmp_path, monkeypatch,
                                       kw):
    """conv='pallas', or a bundle whose frontend is 'pallas', records the
    hand kernels, which have no CPU implementation: with 'cpu' in
    platforms the export raises ValueError, before any model is built."""
    kw = dict(kw)
    dir_models = tmp_path / 'models'
    shutil.copytree(bundle_dir, dir_models / 'testmodel')
    if kw.pop('frontend', None):
        path = dir_models / 'testmodel' / 'config_model.json'
        conf = json.loads(path.read_text())
        conf['frontend'] = 'pallas'
        path.write_text(json.dumps(conf))
    monkeypatch.setattr(cfg, 'DIR_MODELS', str(dir_models))
    with pytest.raises(ValueError, match="platforms=\\('cuda',\\)"):
        export_classifier('testmodel', chunk_seconds=2.0, **kw)


def test_load_exported_on_cuda_without_a_card_raises(models, tmp_path):
    """Asking for the card where torch finds none raises; the artifact does
    not quietly run on the CPU. A device the artifact was not exported for
    raises too."""
    blob, meta = export_classifier('testmodel', chunk_seconds=2.0,
                                   platforms=('cpu',))
    d = save_exported(str(tmp_path / 's'), blob, meta)
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match='CUDA'):
        load_exported(d)
    meta['platforms'] = ['cuda']
    save_exported(d, blob, meta)
    with pytest.raises(ValueError, match='exported for'):
        load_exported(d, device='cpu')


# --- the custom operators ------------------------------------------------------

def _stack_operands(specs, mode, device):
    pw_dtype = torch.float32 if mode == 'highest' else torch.bfloat16
    out = []
    for s in specs:
        pw = ((s.c_in, s.c_out) if mode != 'high'
              else (2, s.c_in, s.c_out))
        out += [torch.empty(9, s.c_in, device=device),
                torch.empty(s.c_in, device=device),
                torch.empty(pw, dtype=pw_dtype, device=device),
                torch.empty(s.c_out, device=device)]
    return out


# the main path's two ranges, and the op's layer 4-7 range without pooling
# (a range of the JAX kernel's signature, which no embed route takes)
RANGES = [('front', 2, 8, False), ('tail', 8, 15, True),
          ('tail', 4, 8, False)]


@pytest.fixture(scope='module')
def yamnet_params():
    from buzzdetect_torch.models.weights import params_from_numpy
    arrays = dict(np.load(os.path.join(REPO, 'models', 'model_general_v3',
                                       'model.npz')))
    raw = params_from_numpy(arrays, 'cpu')['yamnet']
    return {mode: sepconv.pack_params(raw, mode) for mode in sepconv.MODES}


@pytest.mark.parametrize('mode', sepconv.MODES)
@pytest.mark.parametrize('which,start,stop,gap', RANGES)
@pytest.mark.parametrize('batch', [1, 5])
def test_fake_conv_ops_match_the_plain_shapes(yamnet_params, which, start,
                                              stop, gap, mode, batch):
    """What a trace on the card sees (the fake implementation, on fake CUDA
    tensors) has the plain version's shape and dtype."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    params = yamnet_params[mode]
    specs = sepconv.tail_specs(start, stop)
    s0 = specs[0]
    x = torch.zeros(batch, s0.h, s0.w, s0.c_in)
    plain = (sepconv.fused_front_plain(params, x, start_layer=start,
                                       stop_layer=stop, mode=mode)
             if which == 'front' else
             sepconv.fused_tail_plain(params, x, start_layer=start,
                                      stop_layer=stop, gap=gap, mode=mode))
    with FakeTensorMode():
        xf = torch.empty(batch, s0.h, s0.w, s0.c_in, device='cuda')
        ops = _stack_operands(specs, mode, 'cuda')
        fake = (library.fused_front(xf, ops, start, stop, mode)
                if which == 'front' else
                library.fused_tail(xf, ops, start, stop, gap, mode))
        shape, dtype, device = fake.shape, fake.dtype, fake.device
    assert (tuple(shape), dtype) == (tuple(plain.shape), plain.dtype)
    assert device.type == 'cuda'


@pytest.mark.parametrize('batch', [1, 5])
def test_fake_log_mel_matches_the_plain_shape(batch):
    from torch._subclasses.fake_tensor import FakeTensorMode
    fcfg = FrontendConfig()
    n = padded_length(int(2.0 * 16000), fcfg)
    plain = logmel.log_mel_spectrogram_fused_plain(torch.zeros(batch, n),
                                                   fcfg)
    consts = logmel._operands(fcfg, torch.device('cpu'))
    with FakeTensorMode():
        w = torch.empty(batch, n, device='cuda')
        cs = [torch.empty(consts[k].shape, device='cuda')
              for k in ('tables', 'mel')]
        fake = library.log_mel(w, cs, fcfg.window_samples, fcfg.hop_samples,
                               fcfg.log_offset)
        shape, dtype = fake.shape, fake.dtype
    assert (tuple(shape), dtype) == (tuple(plain.shape), plain.dtype)


def test_fake_log_mel_of_the_int16_wire_is_f32():
    """The operator takes the int16 wire as it is and gives f32 log-mel,
    the shape of the plain version's."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    fcfg = FrontendConfig()
    n = padded_length(int(2.0 * 16000), fcfg)
    plain = logmel.log_mel_spectrogram_fused_plain(
        torch.zeros(2, n, dtype=torch.int16), fcfg)
    consts = logmel._operands(fcfg, torch.device('cpu'))
    with FakeTensorMode():
        w = torch.empty(2, n, dtype=torch.int16, device='cuda')
        cs = [torch.empty(consts[k].shape, device='cuda')
              for k in ('tables', 'mel')]
        fake = library.log_mel(w, cs, fcfg.window_samples, fcfg.hop_samples,
                               fcfg.log_offset)
        shape, dtype = fake.shape, fake.dtype
    assert (tuple(shape), dtype) == (tuple(plain.shape), torch.float32)
    assert plain.dtype == torch.float32


def test_log_mel_wrapper_hands_the_wire_to_the_op_as_it_is(monkeypatch):
    """On a CUDA tensor the wrapper passes int16 and f32 samples to the
    operator unconverted (the kernel reads both) and converts any other
    type to f32. Rehearsed on CPU tensors with route forced to 'cuda'."""
    seen = []

    def op(x, constants, *args):
        seen.append(x.dtype)
        return torch.zeros(1, 1, 64)
    monkeypatch.setattr(library, 'log_mel', op)
    monkeypatch.setattr(logmel, 'route', lambda x: 'cuda')
    for dtype in (torch.int16, torch.float32, torch.float64):
        logmel.log_mel_spectrogram_fused(torch.zeros(16000, dtype=dtype),
                                         FrontendConfig())
    assert seen == [torch.int16, torch.float32, torch.float32]


def test_ops_refuse_cpu_tensors():
    """An operator called on CPU tensors raises; it never falls back to the
    plain version (only the wrappers' route reaches those)."""
    specs = sepconv.tail_specs(2, 8)
    x = torch.zeros(1, 48, 32, 32)
    before = (dict(sepconv.fused_front.launches),
              dict(sepconv.fused_tail.launches),
              logmel.log_mel_spectrogram_fused.launches)
    with pytest.raises(NotImplementedError, match='CPU'):
        library.fused_front(x, _stack_operands(specs, 'highest', 'cpu'),
                            2, 8, 'highest')
    with pytest.raises(NotImplementedError, match='CPU'):
        library.fused_tail(x, _stack_operands(specs, 'highest', 'cpu'),
                           2, 8, False, 'highest')
    with pytest.raises(NotImplementedError, match='CPU'):
        library.log_mel(torch.zeros(1, 16000), [torch.zeros(1)] * 2, 400,
                        160, 1e-3)
    assert before == (dict(sepconv.fused_front.launches),
                      dict(sepconv.fused_tail.launches),
                      logmel.log_mel_spectrogram_fused.launches)


def test_wrappers_route_cuda_through_the_ops(monkeypatch):
    """On a CUDA tensor the wrappers call the operators (one route to each
    kernel), with the packed operands flattened in _check's order and the
    layer range resolved; the CPU route is the plain version. Rehearsed on
    CPU tensors with route forced to 'cuda' and the operators spied."""
    from buzzdetect_torch.models.weights import params_from_numpy
    arrays = dict(np.load(os.path.join(REPO, 'models', 'model_general_v3',
                                       'model.npz')))
    params = sepconv.pack_params(params_from_numpy(arrays, 'cpu')['yamnet'],
                                 'bf16')
    calls = []

    def spy(name):
        def op(x, operands, *args):
            calls.append((name, tuple(x.shape), len(operands), args))
            return torch.zeros(1)
        return op

    monkeypatch.setattr(library, 'fused_front', spy('front'))
    monkeypatch.setattr(library, 'fused_tail', spy('tail'))
    monkeypatch.setattr(library, 'log_mel', spy('log_mel'))
    monkeypatch.setattr(sepconv, 'route', lambda x: 'cuda')
    monkeypatch.setattr(logmel, 'route', lambda x: 'cuda')
    sepconv.fused_front(params, torch.zeros(2, 48, 32, 32), mode='bf16')
    sepconv.fused_tail(params, torch.zeros(2, 6, 4, 512), mode='bf16')
    sepconv.fused_tail(params, torch.zeros(2, 24, 16, 128), start_layer=4,
                       stop_layer=8, gap=False, mode='bf16')
    logmel.log_mel_spectrogram_fused(torch.zeros(16000), FrontendConfig())
    assert calls == [
        ('front', (2, 48, 32, 32), 24, (2, 8, 'bf16')),
        ('tail', (2, 6, 4, 512), 28, (8, 15, True, 'bf16')),
        ('tail', (2, 24, 16, 128), 16, (4, 8, False, 'bf16')),
        ('log_mel', (1, 16000), 2, (400, 160, 1e-3))]
