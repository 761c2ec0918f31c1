"""tests/test_gui_viewmodel.py, case for case, against
``buzzdetect_torch.gui`` (import prefix changed, same assertions). Edits:
the two cases the JAX file runs only under an X display
(``test_widgets_construct``,
``test_settings_window_manifest_lock_no_recursion``) run under a display
when there is one and through ``tests/tk_stub.py`` otherwise, so they run
here; ``test_device_field_reaches_analyze`` covers the port's ``device``
field.

The JAX package's docstring:

Headless tests for the GUI view-model (settings defaults, cache,
validation wiring, manifest locking)."""

import json
import os
import sys

import pytest

from buzzdetect_torch.gui.viewmodel import (SettingsModel, analysis_defaults,
                                            BASIC_FIELDS, ADVANCED_FIELDS)
from tests import tk_stub

TORCH_GUI_MODULES = tuple(name.replace('buzzdetect_tpu', 'buzzdetect_torch')
                          for name in tk_stub.GUI_MODULES)


def install_tk_stub():
    """``tk_stub.install()``, also dropping the port's cached gui modules so
    they rebind to the stub."""
    saved = tk_stub.install()
    for name in TORCH_GUI_MODULES:
        saved[name] = sys.modules.pop(name, None)
    return saved


def uninstall_tk_stub(saved):
    for name in TORCH_GUI_MODULES:
        sys.modules.pop(name, None)
        if saved.get(name) is not None:
            sys.modules[name] = saved[name]
    tk_stub.uninstall(saved)


@pytest.fixture()
def tk_toolkit():
    """Real tkinter under a display; else the Tk stub (tests/tk_stub.py),
    which the toolkit tests drive the same windows with."""
    if os.environ.get('DISPLAY'):
        yield None
        return
    saved = install_tk_stub()
    yield tk_stub
    uninstall_tk_stub(saved)


def test_defaults_track_analyze_signature():
    d = analysis_defaults()
    assert d['chunklength'] == 200
    assert d['framehop_prop'] == 1
    assert d['verbosity_print'] == 'PROGRESS'
    assert d['classes_out'] == 'all'
    # every form field exists in the defaults
    for f in (*BASIC_FIELDS, *ADVANCED_FIELDS):
        assert f in d, f


def test_cache_roundtrip(tmp_path):
    path = str(tmp_path / 'guisettings.json')
    m = SettingsModel(path_cache=path)
    m.values['chunklength'] = 60.0
    m.values['modelname'] = 'model_general_v3'
    m.save_cache()

    m2 = SettingsModel(path_cache=path)
    assert m2.values['chunklength'] == 60.0
    assert m2.values['modelname'] == 'model_general_v3'


def test_corrupt_cache_ignored(tmp_path):
    path = str(tmp_path / 'guisettings.json')
    with open(path, 'w') as f:
        f.write('{not json')
    m = SettingsModel(path_cache=path)
    assert m.values['chunklength'] == 200  # defaults survived


def test_validation_wiring(tmp_path):
    m = SettingsModel(path_cache=str(tmp_path / 'g.json'))
    m.values['modelname'] = 'no_such_model_xyz'
    results = m.validate_all()
    assert not results['modelname'].valid
    m.values['precision'] = 2.0
    assert not m.validate_field('precision').valid
    assert not m.ready()


def test_manifest_locking(tmp_path):
    from buzzdetect_torch.manifest import build_manifest, write_manifest
    dir_out = str(tmp_path / 'out')
    write_manifest(dir_out,
                   build_manifest('lockedmodel', 0.5, None, ['a', 'b']))

    m = SettingsModel(path_cache=str(tmp_path / 'g.json'))
    m.values['dir_out'] = dir_out
    locked = m.apply_manifest_lock()
    assert locked['modelname'] == 'lockedmodel'
    assert m.values['modelname'] == 'lockedmodel'
    assert m.values['framehop_prop'] == 0.5
    assert sorted(m.values['classes_out']) == ['a', 'b']


def test_no_manifest_no_lock(tmp_path):
    m = SettingsModel(path_cache=str(tmp_path / 'g.json'))
    m.values['dir_out'] = str(tmp_path / 'fresh')
    assert m.apply_manifest_lock() == {}


def test_orphan_results_fail_dir_out_inline(tmp_path):
    """A dir_out holding result files but no manifest will be refused by
    analyze() (provenance unattestable) — the form must fail the field
    inline instead of letting the child process launch and die."""
    from buzzdetect_torch import config as cfg
    from buzzdetect_torch.manifest import build_manifest, write_manifest

    d = tmp_path / 'out'
    d.mkdir()
    (d / ('rec' + cfg.SUFFIX_RESULT_COMPLETE)).write_text(
        'start,activation_ins_buzz\n0.0,-1.2\n')

    m = SettingsModel(path_cache=str(tmp_path / 'g.json'))
    m.values['dir_out'] = str(d)
    res = m.validate_field('dir_out')
    assert not res.valid and 'manifest' in res.message

    # restoring the manifest clears the inline error (and locks fields)
    write_manifest(str(d), build_manifest('m1', 1.0, None, ['ins_buzz']))
    assert m.validate_field('dir_out').valid

    # a genuinely fresh folder is never flagged
    m.values['dir_out'] = str(tmp_path / 'fresh')
    assert m.validate_field('dir_out').valid


def test_orphan_check_cache_notices_cleanup(tmp_path):
    """The cached directory walk must clear the inline error once the
    offending result files are moved aside (the folder's mtime bumps),
    not stay stale-invalid until the manifest changes."""
    from buzzdetect_torch import config as cfg

    d = tmp_path / 'out'
    d.mkdir()
    bad = d / ('rec' + cfg.SUFFIX_RESULT_PARTIAL)
    bad.write_text('start,detections_ins_buzz\n0.0,1\n')

    m = SettingsModel(path_cache=str(tmp_path / 'g.json'))
    m.values['dir_out'] = str(d)
    assert not m.validate_field('dir_out').valid
    bad.unlink()  # the user moves the old results aside
    assert m.validate_field('dir_out').valid


def test_live_run_lock_fails_dir_out_inline(tmp_path):
    """analyze() refuses a folder another LIVE run owns — the form must
    fail the field inline; a dead owner's debris must NOT block it (the
    run-time guard self-heals that), re-checked per call even when the
    file is unchanged."""
    import json
    import socket

    from buzzdetect_torch import config as cfg

    d = tmp_path / 'out'
    d.mkdir()
    lock = d / cfg.FNAME_LOCK
    lock.write_text(json.dumps({'pid': 1, 'host': socket.gethostname(),
                                'started': 'x'}))
    m = SettingsModel(path_cache=str(tmp_path / 'g.json'))
    m.values['dir_out'] = str(d)
    res = m.validate_field('dir_out')
    assert not res.valid and 'another analysis' in res.message

    # same file, dead pid: the run-time guard will self-heal — unblock
    lock.write_text(json.dumps({'pid': 2 ** 22 + 999, 'host':
                                socket.gethostname(), 'started': 'x'}))
    assert m.validate_field('dir_out').valid

    # a foreign host's lock is unknowable: refuse-side
    lock.write_text(json.dumps({'pid': 2 ** 22 + 999,
                                'host': 'other-box', 'started': 'x'}))
    assert not m.validate_field('dir_out').valid

    lock.unlink()
    assert m.validate_field('dir_out').valid


def test_analyze_kwargs_classes_parsing(tmp_path):
    m = SettingsModel(path_cache=str(tmp_path / 'g.json'))
    m.values['classes_out'] = 'ins_buzz, human'
    kwargs = m.analyze_kwargs()
    assert kwargs['classes_out'] == ['ins_buzz', 'human']
    m.values['classes_out'] = 'all'
    assert m.analyze_kwargs()['classes_out'] == 'all'


def test_widgets_construct(tk_toolkit):
    import tkinter as tk
    from buzzdetect_torch.gui.widgets import TextEntry
    root = tk.Tk()
    w = TextEntry(root, 'test')
    w.set('abc')
    assert w.get() == 'abc'
    root.destroy()


def test_analyze_kwargs_never_collide_with_launcher(tmp_path):
    """run_analysis passes q_gui/event_stopanalysis itself; the kwargs the
    form produces must never contain them (regression: duplicate-kwarg
    TypeError crashed every GUI launch)."""
    import inspect
    from buzzdetect_torch.analysis import analyze
    m = SettingsModel(path_cache=str(tmp_path / 'g.json'))
    kwargs = m.analyze_kwargs()
    assert 'q_gui' not in kwargs
    assert 'event_stopanalysis' not in kwargs
    # and every produced kwarg is a real analyze() parameter
    params = set(inspect.signature(analyze).parameters)
    assert set(kwargs) <= params
    # the exact child-process call must bind without collision
    sig = inspect.signature(analyze)
    sig.bind(q_gui=object(), event_stopanalysis=object(), **kwargs)


def test_coerce_field_empty_optionals_and_numerics():
    """The single form-string coercion path: '' means None for optional
    fields (so validators pass on defaults), numerics follow annotations,
    and junk passes through raw for the validator to report."""
    from buzzdetect_torch.gui.viewmodel import coerce_field
    assert coerce_field('precision', '') is None
    assert coerce_field('n_streamers', '') is None
    assert coerce_field('stream_buffer_depth', '') is None
    assert coerce_field('dir_out', '') is None
    assert coerce_field('precision', '0.95') == 0.95
    assert coerce_field('analyzers_cpu', '2') == 2
    assert coerce_field('framehop_prop', '0.5') == 0.5
    assert coerce_field('chunklength', 'abc') == 'abc'   # validator reports
    assert coerce_field('modelname', 'm') == 'm'
    # '2.9' typed into a COUNT field is a typo to reject, not a value to
    # silently truncate — it stays raw so the validator fires
    assert coerce_field('analyzers_cpu', '2.9') == '2.9'
    assert coerce_field('stream_buffer_depth', '2.9') == '2.9'
    assert coerce_field('analyzers_cpu', '3.0') == 3


def test_profile_field_in_form(tmp_path):
    """The deployment-profile preset is a first-class form field: blank
    coerces to None (no profile), valid names validate and thread into
    analyze_kwargs, junk is rejected inline."""
    from buzzdetect_torch.gui.viewmodel import (SettingsModel, coerce_field,
                                              ADVANCED_FIELDS)
    assert 'profile' in ADVANCED_FIELDS
    assert coerce_field('profile', '') is None
    assert coerce_field('profile', 'field') == 'field'
    m = SettingsModel(path_cache=str(tmp_path / 'cache.json'))
    m.values['profile'] = None
    assert m.validate_field('profile').valid
    m.values['profile'] = 'field'
    assert m.validate_field('profile').valid
    assert m.analyze_kwargs()['profile'] == 'field'
    m.values['profile'] = 'fast'
    assert not m.validate_field('profile').valid


def test_watch_mode_exempts_dir_audio_validation():
    """Watch mode tolerates a not-yet-created recorder directory (CLI
    parity: cli.py skips the dir_audio validator there); the GUI must not
    brick a feature the CLI allows."""
    from buzzdetect_torch.gui.viewmodel import SettingsModel
    m = SettingsModel(path_cache='/nonexistent/never-written.json')
    m.values['dir_audio'] = '/no/such/recorder/dir'
    m.values['watch'] = False
    assert not m.validate_field('dir_audio').valid
    m.values['watch'] = True
    assert m.validate_field('dir_audio').valid


def test_default_form_values_validate():
    """Regression: a fresh form (empty optional fields) must validate —
    previously '' hit float('') in the widget validators and the Analyze
    button silently did nothing."""
    from buzzdetect_torch.gui.viewmodel import coerce_field
    from buzzdetect_torch.validation import validate_map
    d = analysis_defaults()
    for name in ('precision', 'n_streamers', 'stream_buffer_depth',
                 'dir_out'):
        raw = '' if d.get(name) is None else str(d[name])
        assert validate_map[name](coerce_field(name, raw)).valid, name


def test_classes_out_accepts_form_strings():
    """Regression: the GUI holds classes_out as a string; filtering classes
    used to be impossible because only 'all' or a list validated."""
    from buzzdetect_torch.validation import validate_map
    v = validate_map['classes_out']
    assert v('all').valid
    assert v('ins_buzz').valid
    assert v('ins_buzz, human').valid
    assert not v('').valid
    assert not v('   ').valid
    assert v(['ins_buzz']).valid
    assert not v(3).valid
    # and the launcher converts the string to the list analyze() expects
    m = SettingsModel(path_cache='/dev/null')
    m.values['classes_out'] = 'ins_buzz, human'
    assert m.analyze_kwargs()['classes_out'] == ['ins_buzz', 'human']


def test_settings_window_manifest_lock_no_recursion(tk_toolkit, tmp_path,
                                                    monkeypatch):
    """Regression: entry.set() inside _apply_lock fires the Tk write trace,
    which used to re-enter _on_change -> _apply_lock unboundedly whenever
    the output folder held a manifest."""
    from buzzdetect_torch.manifest import build_manifest, write_manifest
    from buzzdetect_torch.gui.settings import AnalysisSettings
    dir_out = str(tmp_path / 'out')
    write_manifest(dir_out,
                   build_manifest('lockedmodel', 0.5, None, ['a', 'b']))
    m = SettingsModel(path_cache=str(tmp_path / 'g.json'))
    m.values['dir_out'] = dir_out
    win = AnalysisSettings(model=m)   # used to raise RecursionError
    try:
        assert win.model.values['framehop_prop'] == 0.5
        # typing into an unlocked field must not recurse either
        win.entries['chunklength'].set('60')
        assert win.model.values['chunklength'] == 60.0
    finally:
        win.destroy()


def test_manifest_lock_adopts_none_pins(tmp_path):
    """precision=None is a meaningful pin (activations mode): a cached
    non-None precision must be overwritten when the manifest pins None, or
    the widget locks on a value the manifest forbids and every launch dies
    on a manifest mismatch the user cannot edit away."""
    from buzzdetect_torch.gui.viewmodel import SettingsModel
    from buzzdetect_torch.manifest import build_manifest, write_manifest

    dir_out = str(tmp_path / 'out')
    write_manifest(dir_out, build_manifest(
        modelname='m', framehop_prop=1.0, precision=None,
        classes_out=['ins_buzz']))
    model = SettingsModel(path_cache=str(tmp_path / 'guisettings.json'))
    model.values['dir_out'] = dir_out
    model.values['precision'] = 0.95  # stale cached value
    locked = model.apply_manifest_lock()
    assert 'precision' in locked
    assert model.values['precision'] is None


def test_analyze_kwargs_normalizes_all_token(tmp_path):
    """' All ' must mean 'all', not a one-item class list that pins a bogus
    manifest and then dies in the writer."""
    from buzzdetect_torch.gui.viewmodel import SettingsModel
    model = SettingsModel(path_cache=str(tmp_path / 'guisettings.json'))
    model.values['classes_out'] = ' All '
    assert model.analyze_kwargs()['classes_out'] == 'all'


def test_detections_manifest_lock_is_launchable(tmp_path):
    """A detections-mode manifest stores classes_out=null; the lock must
    surface 'all' (a valid display value) — otherwise the locked,
    uneditable widget fails form validation and the folder can never be
    resumed from the GUI."""
    from buzzdetect_torch.manifest import build_manifest, write_manifest
    dir_out = str(tmp_path / 'out')
    write_manifest(dir_out, build_manifest('m', 1.0, 0.95, ['a']))

    m = SettingsModel(path_cache=str(tmp_path / 'g.json'))
    m.values['dir_out'] = dir_out
    locked = m.apply_manifest_lock()
    assert locked['classes_out'] == 'all'
    assert m.values['classes_out'] == 'all'
    assert m.validate_field('classes_out').valid


def test_coerce_and_validate_devices_field():
    """The GUI's devices field (per-chip replicas) coerces '' -> None,
    'all' -> 'all', digits -> int, and garbage stays raw for the validator
    to reject."""
    from buzzdetect_torch.gui.viewmodel import (coerce_field, ADVANCED_FIELDS,
                                              SettingsModel)
    assert 'devices' in ADVANCED_FIELDS
    assert coerce_field('devices', '') is None
    assert coerce_field('devices', 'All') == 'all'
    assert coerce_field('devices', '4') == 4
    assert coerce_field('devices', 'lots') == 'lots'

    m = SettingsModel(path_cache='/nonexistent/guisettings.json')
    m.values['devices'] = coerce_field('devices', '2')
    assert m.validate_field('devices').valid
    m.values['devices'] = coerce_field('devices', 'lots')
    assert not m.validate_field('devices').valid
    m.values['devices'] = None
    assert m.validate_field('devices').valid


def test_alert_fields_in_form(tmp_path):
    """The live-alert settings ride the advanced form: string class list
    splits like classes_out, blank disables, threshold coerces to float,
    and the validators accept/reject the form's raw strings."""
    from buzzdetect_torch.gui.viewmodel import (ADVANCED_FIELDS, coerce_field)
    from buzzdetect_torch.validation import validate_map

    assert 'alert_classes' in ADVANCED_FIELDS
    assert 'alert_threshold' in ADVANCED_FIELDS

    m = SettingsModel(path_cache=str(tmp_path / 'g.json'))
    m.values['alert_classes'] = 'ins_buzz, ins_trill'
    m.values['alert_threshold'] = -1.2
    kwargs = m.analyze_kwargs()
    assert kwargs['alert_classes'] == ['ins_buzz', 'ins_trill']
    assert kwargs['alert_threshold'] == -1.2

    # blank form values mean 'alerts off' (None), matching analyze()
    assert coerce_field('alert_classes', '') is None
    assert coerce_field('alert_threshold', '') is None
    assert coerce_field('alert_threshold', '-1.2') == -1.2
    m.values['alert_classes'] = '   '
    assert m.analyze_kwargs()['alert_classes'] is None

    v = validate_map['alert_classes']
    assert v(None).valid
    assert v('ins_buzz human').valid
    assert v(['ins_buzz']).valid
    assert not v([]).valid
    assert not v('   ').valid
    assert not v(123).valid
    vt = validate_map['alert_threshold']
    assert vt(None).valid and vt(-1.2).valid
    assert not vt('abc').valid


def test_alert_cross_field_validation(tmp_path):
    """Alert misconfigurations that analyze() would reject must fail FORM
    validation (inline, before launch) — not crash the spawned analysis
    process: a threshold without classes, or classes with neither a
    threshold nor a precision to calibrate one from."""
    m = SettingsModel(path_cache=str(tmp_path / 'g.json'))

    # threshold alone does nothing -> invalid on the threshold field
    m.values['alert_threshold'] = -1.2
    m.values['alert_classes'] = None
    assert not m.validate_field('alert_threshold').valid
    assert not m.ready()

    # classes with no threshold and no precision -> invalid on classes
    m.values['alert_threshold'] = None
    m.values['alert_classes'] = 'ins_buzz'
    m.values['precision'] = None
    assert not m.validate_field('alert_classes').valid

    # precision supplies a calibrated threshold -> valid
    m.values['precision'] = 0.95
    assert m.validate_field('alert_classes').valid

    # explicit threshold also valid (no precision needed)
    m.values['precision'] = None
    m.values['alert_threshold'] = -1.2
    assert m.validate_field('alert_classes').valid
    assert m.validate_field('alert_threshold').valid

    # an EMPTY form string coerces to None (alerts off) and passes; a
    # whitespace-only string stays raw and the per-field validator rejects
    # it with its own message (established form behavior)
    m.values['alert_threshold'] = None
    m.values['alert_classes'] = None  # what coerce_field('', ...) yields
    assert m.validate_field('alert_classes').valid


def test_device_field_reaches_analyze(tmp_path):
    """The port's form carries analyze()'s ``device`` (default 'cuda'):
    an advanced field, validated ('cuda', 'cuda:N' or 'cpu'), passed on
    as typed."""
    import inspect
    from buzzdetect_torch.analysis import analyze
    from buzzdetect_torch.gui.viewmodel import coerce_field
    assert 'device' in ADVANCED_FIELDS
    assert inspect.signature(analyze).parameters['device'].default == 'cuda'
    m = SettingsModel(path_cache=str(tmp_path / 'g.json'))
    assert m.values['device'] == 'cuda'
    for good in ('cuda', 'cuda:1', 'cpu'):
        m.values['device'] = coerce_field('device', good)
        assert m.validate_field('device').valid, good
        assert m.analyze_kwargs()['device'] == good
    for bad in ('gpu', 'cuda:', 'cpu:0', ''):
        m.values['device'] = coerce_field('device', bad)
        assert not m.validate_field('device').valid, bad
