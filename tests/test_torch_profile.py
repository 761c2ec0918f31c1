"""tests/test_profile.py, case for case, against ``buzzdetect_torch``
(import prefix changed, same assertions). Edits: every run is the port's
on the CPU (the module's ``analyze`` passes ``device='cpu'``); bundles are
built with the port's ``build_model_bundle``. ``clf.conv_precision ==
'highest'`` is the port's exact-f32 mode of the conv kernels (on the CPU,
their plain versions), as it is the JAX package's HIGHEST dots. The
profiled runs also print max |port - JAX| over the CSV scores of the same
recording through the JAX package's ``analyze()`` with the same profile.

The JAX package's docstring:
The --profile deployment presets (config.resolve_profile): one flag in
place of the reference tuning chapter's knob archaeology
(`docs/source/tuning.rst`), with the mu-law caveat logged and the manifest
recording provenance.
"""

import json
import os

import pytest

from buzzdetect_torch import config as cfg
from buzzdetect_torch.manifest import build_manifest
from buzzdetect_torch.models.convert import build_model_bundle
from tests.audio_fixtures import make_tone, write_wav


def analyze(**kw):
    """The port's analyze(), on the CPU."""
    from buzzdetect_torch import analysis
    kw.setdefault('device', 'cpu')
    return analysis.analyze(**kw)


def _vs_jax(dir_models, dir_audio, dir_out, tmp_path, **kw):
    """The JAX package's analyze() of the same recording and bundle with the
    same profile knobs; prints max |port - JAX| over the CSV scores."""
    import numpy as np
    from buzzdetect_tpu import analysis as janalysis
    from buzzdetect_tpu import config as jcfg
    saved = jcfg.DIR_MODELS
    jcfg.DIR_MODELS = str(dir_models)
    try:
        janalysis.analyze(modelname='profmodel', dir_audio=str(dir_audio),
                          dir_out=str(tmp_path / 'jax'), chunklength=2.0,
                          verbosity_print='ERROR', **kw)
    finally:
        jcfg.DIR_MODELS = saved
    name = 'rec' + cfg.SUFFIX_RESULT_COMPLETE
    port = np.loadtxt(os.path.join(dir_out, name), delimiter=',',
                      skiprows=1, ndmin=2)
    ref = np.loadtxt(tmp_path / 'jax' / name, delimiter=',', skiprows=1,
                     ndmin=2)
    assert port.shape == ref.shape
    err = float(np.abs(port - ref).max())
    print(f'{kw}: max |port - JAX| over CSV scores = {err}')
    return err


def test_resolve_profile_field_fills_unset_knobs():
    td, strict, note = cfg.resolve_profile('field', None, False)
    assert td == 'mulaw' and strict is False
    assert note and 'mu-law' in note and 'silen' in note  # the caveat

    # explicit transfer_dtype wins; no caveat note for a knob it didn't set
    td, strict, note = cfg.resolve_profile('field', 'int16', False)
    assert td == 'int16' and note is None


def test_resolve_profile_strict():
    td, strict, note = cfg.resolve_profile('strict', None, False)
    assert td == 'float32' and strict is True and note is None
    # explicit wire format survives; strict precision is the profile's point
    td, strict, _ = cfg.resolve_profile('strict', 'int16', False)
    assert td == 'int16' and strict is True


def test_resolve_profile_validation():
    assert cfg.resolve_profile(None, 'int16', False) == ('int16', False, None)
    with pytest.raises(ValueError, match='profile'):
        cfg.resolve_profile('fast', None, False)


def test_manifest_profile_key_wire_compat():
    """No profile -> the manifest dict is byte-compatible with the
    reference format (no extra key); with one, the key rides along as
    informational provenance that never blocks resume."""
    base = build_manifest('m', 1.0, None, ['a', 'b'])
    assert 'profile' not in base
    rec = build_manifest('m', 1.0, None, ['a', 'b'], profile='field')
    assert rec['profile'] == 'field'
    # not a locked key: a profile-less rerun into a profiled folder admits
    from buzzdetect_torch.manifest import diff_manifests
    assert diff_manifests(rec, base) == []
    assert diff_manifests(base, rec) == []


def test_analyze_profile_field_end_to_end(tmp_path, monkeypatch):
    """profile='field' selects the mu-law wire, records itself in the
    manifest, and logs the digital-silence caveat."""

    dir_models = tmp_path / 'models'
    build_model_bundle(str(dir_models / 'profmodel'),
                       classes=['ins_buzz', 'ambient_noise'], seed=5)
    monkeypatch.setattr(cfg, 'DIR_MODELS', str(dir_models))
    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    write_wav(dir_audio / 'rec.wav', make_tone(2.0, 16000, 220), 16000)

    dir_out = tmp_path / 'out'
    analyzer = analyze(modelname='profmodel', dir_audio=str(dir_audio),
                       dir_out=str(dir_out), chunklength=2.0,
                       verbosity_print='ERROR', profile='field')
    assert analyzer.model.transfer_dtype == 'mulaw'
    with open(dir_out / 'buzzdetect_manifest.json') as f:
        assert json.load(f)['profile'] == 'field'
    logs = [p for p in os.listdir(dir_out) if p.endswith('.log')]
    assert logs
    text = (dir_out / logs[0]).read_text()
    assert 'mu-law' in text and "profile 'field'" in text
    _vs_jax(dir_models, dir_audio, dir_out, tmp_path, profile='field')

    # explicit transfer_dtype beats the profile
    analyzer2 = analyze(modelname='profmodel', dir_audio=str(dir_audio),
                        dir_out=str(tmp_path / 'out2'), chunklength=2.0,
                        verbosity_print='ERROR', profile='field',
                        transfer_dtype='int16')
    assert analyzer2.model.transfer_dtype == 'int16'


def test_analyze_profile_strict_sets_precision(tmp_path, monkeypatch):

    dir_models = tmp_path / 'models'
    build_model_bundle(str(dir_models / 'profmodel'),
                       classes=['ins_buzz', 'ambient_noise'], seed=5)
    monkeypatch.setattr(cfg, 'DIR_MODELS', str(dir_models))
    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    write_wav(dir_audio / 'rec.wav', make_tone(2.0, 16000, 220), 16000)

    analyzer = analyze(modelname='profmodel', dir_audio=str(dir_audio),
                       dir_out=str(tmp_path / 'out'), chunklength=2.0,
                       verbosity_print='ERROR', profile='strict')
    clf = analyzer.model.classifier
    assert analyzer.model.transfer_dtype == 'float32'
    assert clf.conv_precision == 'highest'
    _vs_jax(dir_models, dir_audio, tmp_path / 'out', tmp_path,
            profile='strict')


def test_analyze_bare_strict_f32(tmp_path, monkeypatch):
    """strict_f32=True without a profile pins the conv dots to HIGHEST
    while leaving the wire format at its default (int16) — the two knobs
    compose independently."""

    dir_models = tmp_path / 'models'
    build_model_bundle(str(dir_models / 'profmodel'),
                       classes=['ins_buzz', 'ambient_noise'], seed=5)
    monkeypatch.setattr(cfg, 'DIR_MODELS', str(dir_models))
    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    write_wav(dir_audio / 'rec.wav', make_tone(2.0, 16000, 220), 16000)

    analyzer = analyze(modelname='profmodel', dir_audio=str(dir_audio),
                       dir_out=str(tmp_path / 'out'), chunklength=2.0,
                       verbosity_print='ERROR', strict_f32=True)
    clf = analyzer.model.classifier
    assert clf.conv_precision == 'highest'
    assert not clf._conv_precision_auto  # survives a conv fallback flip
    assert analyzer.model.transfer_dtype == 'int16'
    _vs_jax(dir_models, dir_audio, tmp_path / 'out', tmp_path,
            strict_f32=True)


def test_watch_mode_shared_loader_honors_profile(tmp_path, monkeypatch):
    """Watch mode loads its models ONCE in analyze()'s shared block, not
    per pass — the profile must resolve there too, or watch runs would
    silently ignore it (the exact single-site-drift _load_serving_models
    exists to prevent)."""

    dir_models = tmp_path / 'models'
    build_model_bundle(str(dir_models / 'profmodel'),
                       classes=['ins_buzz', 'ambient_noise'], seed=5)
    monkeypatch.setattr(cfg, 'DIR_MODELS', str(dir_models))
    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    write_wav(dir_audio / 'rec.wav', make_tone(2.0, 16000, 220), 16000)

    analyzer = analyze(modelname='profmodel', dir_audio=str(dir_audio),
                       dir_out=str(tmp_path / 'out'), chunklength=2.0,
                       verbosity_print='ERROR', profile='field',
                       watch=True, watch_interval=0.05, watch_cycles=2)
    assert analyzer.model.transfer_dtype == 'mulaw'
    with open(tmp_path / 'out' / 'buzzdetect_manifest.json') as f:
        assert json.load(f)['profile'] == 'field'


def test_cli_accepts_profile(tmp_path, monkeypatch):
    """The flag parses and threads into analyze() (the CLI imports
    analyze lazily inside main, so patch it at its definition site)."""
    import buzzdetect_torch.analysis as analysis
    import buzzdetect_torch.cli as cli

    seen = {}

    def fake_analyze(**kw):
        seen.update(kw)

        class A:
            class coordinator:
                end_reason = 'completed'
        return A()

    dir_models = tmp_path / 'models'
    build_model_bundle(str(dir_models / 'climodel'),
                       classes=['ins_buzz', 'ambient_noise'], seed=5)
    monkeypatch.setattr(cfg, 'DIR_MODELS', str(dir_models))
    monkeypatch.setattr(analysis, 'analyze', fake_analyze)
    rc = cli.main(['--modelname', 'climodel', '--dir_audio', str(tmp_path),
                   '--dir_out', str(tmp_path / 'o'), '--profile', 'field'])
    assert seen.get('profile') == 'field'
    assert seen.get('strict_f32') is False
    assert rc in (None, 0)
