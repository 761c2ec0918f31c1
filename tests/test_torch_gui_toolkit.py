"""tests/test_gui_toolkit.py, case for case, against ``buzzdetect_torch.gui``
(import prefix changed, same assertions). Edits: the settings form sets the
port's ``device`` field to ``'cpu'`` (the spawned child runs the port's
``analyze()``, which defaults to the card), and the ``gui`` fixture drops
the port's cached gui modules as ``tk_stub.install()`` drops the JAX
package's.

The JAX package's docstring:

Drive the GUI toolkit layer (settings window, widgets, analysis window)
headlessly through the Tk stub — one full settings -> run -> stop/rerun
cycle with a REAL analysis child process behind the window.

This covers the window code the DISPLAY-gated tests skip in CI
(reference surface: `src/gui/settings.py:16-531`, `src/gui/analysis.py:12-242`).
"""

import os
import sys
import time

import pytest

from buzzdetect_torch import config as cfg
from buzzdetect_torch.models.convert import build_model_bundle
from tests import tk_stub
from tests.audio_fixtures import make_tone, write_wav


@pytest.fixture(scope='module')
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp('guienv')
    dir_models = root / 'models'
    build_model_bundle(str(dir_models / 'testmodel'),
                       classes=['a', 'ins_buzz'], seed=3)
    dir_audio = root / 'audio_in'
    dir_audio.mkdir()
    write_wav(dir_audio / 'tone.wav', make_tone(3.0, 16000, 220), 16000)
    return {'models': str(dir_models), 'audio': str(dir_audio)}


TORCH_GUI_MODULES = tuple(name.replace('buzzdetect_tpu', 'buzzdetect_torch')
                          for name in tk_stub.GUI_MODULES)


@pytest.fixture()
def gui(monkeypatch, env):
    saved = tk_stub.install()
    # tk_stub drops the JAX package's cached gui modules; drop the port's
    # too, so they rebind to the stub
    for name in TORCH_GUI_MODULES:
        saved[name] = sys.modules.pop(name, None)
    # the analysis child is a spawn process: it sees env vars, not
    # monkeypatched module attributes
    monkeypatch.setenv('BUZZDETECT_DIR_MODELS', env['models'])
    monkeypatch.setattr(cfg, 'DIR_MODELS', env['models'])
    yield tk_stub
    for name in TORCH_GUI_MODULES:
        sys.modules.pop(name, None)
        if saved.get(name) is not None:
            sys.modules[name] = saved[name]
    tk_stub.uninstall(saved)


def _pump_until(gui, predicate, timeout=180.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        gui.SCHEDULER.pump()
        if predicate():
            return True
        time.sleep(0.1)
    return False


def _make_settings(env, tmp_path, cache_name='guisettings.json'):
    from buzzdetect_torch.gui.settings import AnalysisSettings
    from buzzdetect_torch.gui.viewmodel import SettingsModel
    model = SettingsModel(path_cache=str(tmp_path / cache_name))
    win = AnalysisSettings(model)
    win.entries['modelname'].set('testmodel')
    win.entries['dir_audio'].set(env['audio'])
    win.entries['dir_out'].set(str(tmp_path / 'out'))
    win.entries['verbosity_print'].set('DEBUG')
    win.entries['device'].set('cpu')
    return win


def test_settings_window_builds_and_validates(gui, env, tmp_path,
                                              monkeypatch):
    win = _make_settings(env, tmp_path)
    from buzzdetect_torch.gui.viewmodel import BASIC_FIELDS, ADVANCED_FIELDS
    assert set(win.entries) == set(BASIC_FIELDS) | set(ADVANCED_FIELDS)

    # inline validation: invalid framehop shows a message, valid clears it
    fh = win.entries['framehop_prop']
    fh.set('-1')
    assert not fh.validate()
    assert fh.message.cget('text')
    fh.set('1')
    assert fh.validate()
    assert fh.message.cget('text') == ''

    # advanced section toggles
    assert not win.advanced_frame.packed
    win.advanced_open.set(True)
    win._toggle_advanced()
    assert win.advanced_frame.packed

    # launch with an invalid field must NOT open the analysis window
    launched = []
    import buzzdetect_torch.gui.analysis as analysis_mod
    monkeypatch.setattr(analysis_mod, 'AnalysisWindow',
                        lambda *a, **k: launched.append(a))
    fh.set('-1')
    win.launch_button.invoke()
    assert launched == []
    fh.set('1')
    win.launch_button.invoke()
    assert len(launched) == 1
    # settings persisted on successful launch
    assert os.path.exists(win.model.path_cache)


def test_watch_toggle_refreshes_dir_audio_validity(gui, env, tmp_path):
    """The watch checkbox changes dir_audio's validity (the documented
    watch_exempt rule: a watched folder may not exist yet). Toggling it must
    re-render dir_audio's message in place — a stale 'does not exist' error
    after checking watch (or a missing one after unchecking) shows the user
    the opposite of what Analyze will do."""
    win = _make_settings(env, tmp_path, 'watchval.json')
    da = win.entries['dir_audio']
    da.set(str(tmp_path / 'missing_folder'))
    assert da.message.cget('text'), 'expected an inline error to render'
    win.entries['watch'].box.invoke()   # user click: on -> fires _on_change
    assert win.entries['watch'].get() is True
    assert da.message.cget('text') == '', \
        'watch exemption should have cleared the stale error'
    win.entries['watch'].box.invoke()   # off again
    assert da.message.cget('text'), \
        'unchecking watch should restore the validity error'


def test_manifest_lock_disables_schema_fields(gui, env, tmp_path):
    import json
    out = tmp_path / 'locked_out'
    out.mkdir()
    manifest = {'modelname': 'testmodel', 'classes_out': ['ins_buzz'],
                'precision': None, 'framehop_prop': 1.0}
    from buzzdetect_torch.manifest import FNAME_MANIFEST
    (out / FNAME_MANIFEST).write_text(json.dumps(manifest))

    win = _make_settings(env, tmp_path, 'lock.json')
    win.entries['dir_out'].set(str(out))  # fires _on_change -> _apply_lock
    assert win.entries['modelname'].entry.kw.get('state') == 'disabled'
    # pointing elsewhere unlocks
    win.entries['dir_out'].set(str(tmp_path / 'elsewhere'))
    assert win.entries['modelname'].entry.kw.get('state') == 'normal'


def test_full_run_stop_rerun_cycle(gui, env, tmp_path):
    """settings -> Analyze -> child process analyze() completes -> Rerun ->
    Stop mid-run -> orderly interrupted shutdown. Everything through the
    real window code; only the toolkit is stubbed."""
    win = _make_settings(env, tmp_path, 'cycle.json')
    win.launch_button.invoke()   # opens the REAL AnalysisWindow

    awin = win.children[-1]
    from buzzdetect_torch.gui.analysis import AnalysisWindow
    assert isinstance(awin, AnalysisWindow)
    assert awin.process.is_alive() or awin.q_gui is not None

    # run 1: completes; final records land in the textbox and buttons flip
    assert _pump_until(gui, lambda: awin.btn_rerun.kw.get('state') == 'normal')
    text = awin.textbox.get_text()
    assert 'Analysis complete' in text
    # the structured outcome line from buzzdetect_run_summary.json
    assert '[run summary] completed: 1 file(s) finalized, 0 failed' in text
    assert awin.btn_stop.kw.get('state') == 'disabled'
    assert os.path.exists(os.path.join(str(tmp_path / 'out'),
                                       'tone_buzzdetect.csv'))

    # run 2: rerun (resume path: everything already analyzed), then stop.
    # The stop button asks for confirmation — the stub messagebox says yes.
    awin.btn_rerun.invoke()
    assert awin.process.is_alive()
    awin.btn_stop.invoke()       # -> event_stop.set() via askyesno=True
    assert awin.event_stop.is_set() or not awin.process.is_alive()
    assert _pump_until(gui, lambda: awin.btn_rerun.kw.get('state') == 'normal')
    awin.process.join(timeout=30)
    assert not awin.process.is_alive()

    # closing the window cancels the poll and destroys cleanly
    awin.kw['protocol:WM_DELETE_WINDOW']()
    assert awin.destroyed
    assert awin._poll_handle is None


def test_outcome_line_renders_for_default_output_run(gui, env, tmp_path):
    """The structured outcome line must render when dir_out is left BLANK.

    A blank dir_out field is legal (OPTIONAL_EMPTY_FIELDS): the child
    resolves the model's default output folder (config.default_dir_out)
    and writes its run summary there. _append_outcome used to return
    early on the falsy kwarg, so the outcome feature was dead exactly in
    the GUI's zero-config path — it must resolve the summary with the
    same rule the child uses."""
    win = _make_settings(env, tmp_path, 'defaultout.json')
    win.entries['dir_out'].set('')
    win.launch_button.invoke()

    awin = win.children[-1]
    from buzzdetect_torch.gui.analysis import AnalysisWindow
    assert isinstance(awin, AnalysisWindow)
    assert _pump_until(gui, lambda: awin.btn_rerun.kw.get('state') == 'normal')
    text = awin.textbox.get_text()
    # the child really ran into the default folder...
    default_out = cfg.default_dir_out('testmodel')
    assert os.path.exists(os.path.join(default_out, 'tone_buzzdetect.csv'))
    # ...and the outcome line found the summary there
    assert '[run summary] completed: 1 file(s) finalized, 0 failed' in text
    awin.kw['protocol:WM_DELETE_WINDOW']()


def test_manifest_lock_no_trace_recursion_at_init(gui, env, tmp_path):
    """Stub-harness version of the DISPLAY-gated regression test: entry
    .set() inside _apply_lock fires the write trace (the stub reproduces
    tkinter's fire-even-when-unchanged semantics), which used to re-enter
    _on_change -> _apply_lock unboundedly when the cached dir_out already
    held a manifest at window construction."""
    from buzzdetect_torch.manifest import build_manifest, write_manifest
    from buzzdetect_torch.gui.settings import AnalysisSettings
    from buzzdetect_torch.gui.viewmodel import SettingsModel
    dir_out = str(tmp_path / 'out')
    write_manifest(dir_out,
                   build_manifest('testmodel', 0.5, None, ['ins_buzz']))
    m = SettingsModel(path_cache=str(tmp_path / 'g.json'))
    m.values['dir_out'] = dir_out
    win = AnalysisSettings(model=m)   # used to raise RecursionError
    assert win.model.values['framehop_prop'] == 0.5
    assert win.entries['framehop_prop'].entry.kw.get('state') == 'disabled'


def test_full_run_with_alerts_and_hook(gui, env, tmp_path):
    """Live alerts configured through the real settings form reach the GUI
    log pane (DETECTED line from the spawned child) and the notification
    command runs in the child with the event's BUZZ_* data."""
    import sys as _sys
    hook_out = tmp_path / 'hook.txt'
    win = _make_settings(env, tmp_path, 'alerts.json')
    win.entries['alert_classes'].set('ins_buzz')
    win.entries['alert_threshold'].set('-1e9')
    win.entries['alert_command'].set(
        f'{_sys.executable} -c "import os; '
        f"open(r'{hook_out}', 'a').write(os.environ['BUZZ_CLASS'] + ' ' + "
        f"os.environ['BUZZ_IDENT'] + chr(10))\"")
    win.launch_button.invoke()
    awin = win.children[-1]
    assert _pump_until(gui, lambda: awin.btn_rerun.kw.get('state') == 'normal')
    text = awin.textbox.get_text()
    assert 'DETECTED ins_buzz' in text
    assert hook_out.exists()
    assert any(line.startswith('ins_buzz ')
               for line in hook_out.read_text().splitlines())
    awin.kw['protocol:WM_DELETE_WINDOW']()


def test_cross_field_alert_misconfig_blocks_launch(gui, env, tmp_path,
                                                   monkeypatch):
    """A cross-field alert misconfiguration (threshold without classes)
    must fail at the form — inline message on the field, no analysis
    window — instead of crashing the spawned child process."""
    win = _make_settings(env, tmp_path, cache_name='cross.json')
    launched = []
    import buzzdetect_torch.gui.analysis as analysis_mod
    monkeypatch.setattr(analysis_mod, 'AnalysisWindow',
                        lambda *a, **k: launched.append(a))

    thr = win.entries['alert_threshold']
    thr.set('-1.2')  # alert_classes left blank
    win.launch_button.invoke()
    assert launched == []
    # the reason lands inline on the widget (the per-field validator
    # passed, so only the cross-field gate can have written it)
    assert 'alert_classes' in thr.message.cget('text')
    # and the status line names the field
    assert 'alert_threshold' in win.status_label.cget('text')

    # typing the missing classes clears the cross-field error on the OTHER
    # widget immediately (no stale 'invalid' state until the next click)
    win.entries['alert_classes'].set('ins_buzz')
    assert thr.message.cget('text') == ''

    # completing the pair launches
    win.launch_button.invoke()
    assert len(launched) == 1
