"""The port's alert notification hook (``buzzdetect_torch.runtime.
alert_command``), on the CPU.

Mirrors tests/test_alert_command.py test for test against
``buzzdetect_torch``. Edits: ``analyze()`` runs with ``device='cpu'``; the
bundle is made by the port's ``build_model_bundle``; the cross-field rule
is tested on the port's GUI form (``buzzdetect_torch.gui.viewmodel.
SettingsModel``), as the JAX case tests the JAX GUI's.

The JAX package's docstring:

The alert notification hook: a user command run on each live alert.

Design contracts under test (runtime/alert_command.py): event data via
BUZZ_* env vars only (no interpolation into shell syntax), non-blocking
bounded dispatch (drops counted, never stalls the writer), warn-once on
failures with a close-time summary, and end-to-end wiring through
analyze(alert_command=...).
"""

import os
import sys
import time

import numpy as np
import pytest

from buzzdetect_torch.runtime.alert_command import AlertCommandRunner

FIELDS = {'class': 'ins_buzz', 'ident': 'sub/rec 1', 'audio': '/a/b.wav',
          'start': 1.92, 'end': 4.8, 'frames': 3, 'peak': '1.25',
          'threshold': -2.0}


def _logger(records):
    return lambda msg, level: records.append((level, msg))


def _wait_for(predicate, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return False


def test_runner_passes_event_env(tmp_path):
    """Every alert field arrives as a BUZZ_* env var — including idents
    with spaces/slashes, which must never touch shell syntax."""
    out = tmp_path / 'got.txt'
    cmd = (f'{sys.executable} -c "import os; '
           f"open(r'{out}', 'w').write('|'.join("
           f"os.environ['BUZZ_' + k] for k in "
           f"['CLASS', 'IDENT', 'AUDIO', 'START', 'END', 'FRAMES', "
           f"'PEAK', 'THRESHOLD']))\"")
    log = []
    runner = AlertCommandRunner(cmd, _logger(log))
    runner.submit(FIELDS)
    runner.close(timeout=15.0)
    assert out.read_text() == \
        'ins_buzz|sub/rec 1|/a/b.wav|1.92|4.8|3|1.25|-2.0'
    assert log == []  # clean run: no warnings


def test_runner_warns_once_and_summarizes_failures():
    log = []
    runner = AlertCommandRunner('exit 3', _logger(log))
    for _ in range(4):
        runner.submit(FIELDS)
    runner.close(timeout=15.0)
    warns = [m for lvl, m in log if lvl == 'WARNING']
    assert len(warns) == 2  # first failure + close summary, NOT 4
    # order-independent: the failure warn comes from the drain thread and
    # the summary from close(); assert content, not arrival order
    assert any('exit 3' in w for w in warns)
    assert any('4 of 4' in w for w in warns)


def test_runner_drops_instead_of_blocking(tmp_path):
    """A slow command during an alert storm: submits stay instant, the
    overflow is dropped and counted, and close() stays bounded."""
    log = []
    gate = tmp_path / 'gate'
    started = tmp_path / 'started'
    # the command announces itself, then blocks until the test releases it
    cmd = (f'{sys.executable} -c "import os, time\n'
           f"open(r'{started}', 'w').write('x')\n"
           f"while not os.path.exists(r'{gate}'): time.sleep(0.01)\"")
    runner = AlertCommandRunner(cmd, _logger(log), depth=2)
    runner.submit(FIELDS)
    assert _wait_for(started.exists)  # first alert is IN FLIGHT (dequeued)
    t0 = time.monotonic()
    for _ in range(9):
        runner.submit(FIELDS)  # 2 fill the queue; 7 dropped
    assert time.monotonic() - t0 < 1.0
    assert runner._dropped == 7
    gate.write_text('go')
    runner.close(timeout=15.0)
    # order-independent: under suite load close() may hit the abandon path
    # first, so the "abandoning dispatch" line can precede the drop summary —
    # both are correct behavior; asserting on dropped[0] was order-flaky
    dropped = [m for lvl, m in log if 'dropped' in m]
    assert any('7 alert(s)' in m for m in dropped)


def test_runner_kills_hung_command():
    log = []
    runner = AlertCommandRunner(
        f'{sys.executable} -c "import time; time.sleep(600)"',
        _logger(log), timeout_s=0.3)
    runner.submit(FIELDS)
    assert _wait_for(lambda: runner._failures == 1, timeout=15.0)
    runner.close(timeout=15.0)
    assert any('timeout' in m for _, m in log)


def test_kill_reaches_the_whole_process_group(tmp_path):
    """A hung hook's own children must die with it — 'hung commands are
    killed' means the work it spawned, not just the shell."""
    pidf = tmp_path / 'grandchild.pid'
    # shell primitives, not python: interpreter startup can exceed the
    # kill timeout on a loaded host. exec keeps the announced pid.
    cmd = (f"sh -c 'echo $$ > \"{pidf}\"; exec sleep 600' & sleep 600")
    runner = AlertCommandRunner(cmd, _logger([]), timeout_s=1.5)
    runner.submit(FIELDS)
    assert _wait_for(pidf.exists)  # grandchild alive before the kill
    assert _wait_for(lambda: runner._failures == 1, timeout=15.0)
    pid = int(pidf.read_text())

    def _gone():
        try:
            os.kill(pid, 0)
            return False
        except ProcessLookupError:
            return True
    assert _wait_for(_gone, timeout=10.0), \
        'backgrounded grandchild survived the group kill'
    runner.close(timeout=15.0)


def test_backgrounding_hook_is_not_hung(tmp_path):
    """The `notify.sh &` idiom: the shell exits instantly while a
    grandchild inherits stderr. That must count as SUCCESS immediately —
    not burn the kill timeout per alert as a false 'hung' failure."""
    log = []
    # grandchild holds the inherited stderr open long past the timeout
    cmd = 'sleep 30 & exit 0'
    runner = AlertCommandRunner(cmd, _logger(log), timeout_s=5.0)
    t0 = time.monotonic()
    runner.submit(FIELDS)
    runner.close(timeout=10.0)
    assert time.monotonic() - t0 < 4.0  # returned with the shell, not the 5s kill
    assert runner._failures == 0
    assert log == []


def test_analyze_requires_alert_classes():
    from buzzdetect_torch.analysis import analyze
    with pytest.raises(ValueError, match='alert_command without'):
        analyze(modelname='nonexistent', alert_command='echo hi',
                device='cpu')


def test_viewmodel_cross_field_rule():
    from buzzdetect_torch.gui.viewmodel import SettingsModel
    m = SettingsModel()
    m.values['alert_command'] = 'echo hi'
    v = m.validate_field('alert_command')
    assert not v.valid and 'alert_classes' in v.message
    m.values['alert_classes'] = 'ins_buzz'
    m.values['alert_threshold'] = -2.0
    assert m.validate_field('alert_command').valid
    kwargs = m.analyze_kwargs()
    assert kwargs['alert_command'] == 'echo hi'


def test_pipeline_runs_alert_command(tmp_path):
    """End to end: analyze(alert_classes=..., alert_command=...) runs the
    hook with the event's data for a real detection."""
    from buzzdetect_torch import config as cfg
    from buzzdetect_torch.models.convert import build_model_bundle
    from buzzdetect_torch.analysis import analyze
    from tests.audio_fixtures import make_tone, write_wav

    dir_models = tmp_path / 'models'
    build_model_bundle(str(dir_models / 'alertmodel'),
                       classes=['ins_buzz', 'ambient_noise'], seed=5)
    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    write_wav(dir_audio / 'rec.wav', make_tone(3.0, 16000, 220), 16000)

    out = tmp_path / 'alerts.log'
    cmd = (f'{sys.executable} -c "import os; '
           f"open(r'{out}', 'a').write("
           f"os.environ['BUZZ_CLASS'] + ' ' + os.environ['BUZZ_IDENT'] "
           f"+ ' ' + os.environ['BUZZ_START'] + chr(10))\"")

    old = cfg.DIR_MODELS
    cfg.DIR_MODELS = str(dir_models)
    try:
        analyze(modelname='alertmodel', dir_audio=str(dir_audio),
                dir_out=str(tmp_path / 'out'), chunklength=3.0,
                verbosity_print='ERROR', alert_classes=['ins_buzz'],
                alert_threshold=-1e9, alert_command=cmd, device='cpu')
    finally:
        cfg.DIR_MODELS = old  # match the suite's patched_models pattern
    assert _wait_for(lambda: out.exists(), timeout=10.0)
    line = out.read_text().splitlines()[0]
    assert line.startswith('ins_buzz rec ')


def test_close_is_bounded_and_abandons(tmp_path):
    """close() with a backlog of a slow command must return within its own
    bound, warn that dispatch was abandoned, count the stranded alerts as
    drops, and the drain thread must stop launching commands (at most the
    in-flight one, under its kill timeout) — the writer join can never be
    held hostage by a notifier."""
    log = []
    started = tmp_path / 'started'
    # each invocation: announce, then outlive the kill timeout (shell
    # primitives — python startup can exceed the timeout on a loaded host)
    cmd = f'echo x >> "{started}"; exec sleep 600'
    runner = AlertCommandRunner(cmd, _logger(log), depth=8, timeout_s=1.0)
    runner.submit(FIELDS)
    assert _wait_for(started.exists)  # first command in flight
    for _ in range(8):
        runner.submit(FIELDS)  # a full queue behind it

    t0 = time.monotonic()
    runner.close(timeout=0.5)
    assert time.monotonic() - t0 < 3.0  # bounded, not 9 x kill-timeout
    assert any('abandoning' in m for _, m in log)
    # the stranded backlog is counted INTO the close summary itself — not
    # left for the drain thread to tally after close() already summarized
    assert any('8 alert(s) dropped' in m for _, m in log)

    # the drain thread dies after the in-flight kill; launches stop at
    # abandonment (the close grace window may admit one more — never the
    # whole backlog serially at kill-timeout each)
    assert _wait_for(lambda: not runner._thread.is_alive(), timeout=15.0)
    time.sleep(0.2)
    assert runner._launched <= 2
    # conservation: every one of the 9 submitted alerts either launched
    # or was counted as a drop — none vanish silently
    assert runner._launched + runner._dropped == 9
    runner.close()  # idempotent: no duplicate summary
    assert sum('abandoning' in m for _, m in log) == 1


def test_stats_snapshot_flags_unfinal_counts(tmp_path):
    """stats() is the summary's authoritative source: after a clean close
    the counts are final; after an ABANDONED close (a command still in
    flight on the daemon thread) that command may add one more failure
    after the snapshot — stats() must say so ('final': False) instead of
    letting the run summary silently undercount."""
    log = []
    runner = AlertCommandRunner('true', _logger(log), depth=4,
                                timeout_s=5.0)
    runner.submit(FIELDS)
    assert _wait_for(lambda: runner._launched == 1)
    runner.close()
    s = runner.stats()
    assert s == {'launched': 1, 'failures': 0, 'dropped': 0, 'final': True}

    log2 = []
    started = tmp_path / 'started'
    cmd = f'echo x >> "{started}"; exec sleep 600'
    # kill-timeout long enough that the command is still in flight at the
    # snapshot, short enough that the drain thread reaps it soon after
    hung = AlertCommandRunner(cmd, _logger(log2), depth=4, timeout_s=3.0)
    hung.submit(FIELDS)
    assert _wait_for(started.exists)  # command in flight
    hung.close(timeout=0.3)  # abandons: the sleep outlives the grace
    s2 = hung.stats()
    assert s2['launched'] == 1 and s2['final'] is False
    # after the in-flight command resolves the counts become final
    assert _wait_for(lambda: hung.stats()['final'], timeout=15.0)
    assert hung.stats()['failures'] == 1  # the kill counted, post-snapshot


def test_validator_accepts_blank_as_no_hook():
    """`--alert_command "$HOOK"` with HOOK unset must pass validation —
    blank means "no hook" everywhere the engine reads it, and the CLI
    path has no ''->None coercion."""
    from buzzdetect_torch.validation import validate_alert_command
    assert validate_alert_command(None).valid
    assert validate_alert_command('').valid
    assert validate_alert_command('   ').valid
    assert validate_alert_command('echo hi').valid
    assert not validate_alert_command(42).valid


def test_whitespace_command_means_no_hook():
    """' ' follows the GUI's blank-field convention (no hook) — a bare
    shell must not spawn per alert."""
    from buzzdetect_torch.runtime.writer import WorkerWriter

    class _Coord:
        class q_log:
            @staticmethod
            def put(x):
                pass

    w = WorkerWriter(classes_out=['ins_buzz'], threshold=None,
                     classes=['ins_buzz'], framehop_s=0.96, digits_time=2,
                     digits_results=2, coordinator=_Coord(),
                     alert=(['ins_buzz'], [0], -2.0, 0.96),
                     alert_command='   ')
    assert w.alert_runner is None
