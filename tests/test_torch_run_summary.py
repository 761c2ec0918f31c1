"""tests/test_run_summary.py, case for case, against ``buzzdetect_torch``
(import prefix changed, same assertions). Edits: every run is the port's
``analyze()`` on ``device='cpu'`` (the module's ``analyze`` wrapper); the
GUI outcome case drives ``buzzdetect_torch.gui.analysis.AnalysisWindow``.

The JAX package's docstring:

Machine-readable run outcome: ``buzzdetect_run_summary.json``.

The supervisor-facing counterpart of the CLI exit-code contract: every
end path — completed, fully analyzed, manifest mismatch, failed files —
must atomically leave a summary describing HOW the run ended and what it
did, so unattended deployments react without parsing the human log.
(Superset capability: the reference offers only the log text.)
"""

import json
import os

import pytest

from buzzdetect_torch import config as cfg
from buzzdetect_torch.models.convert import build_model_bundle
from tests.audio_fixtures import make_tone, write_wav


def analyze(**kw):
    """The port's analyze(), on the CPU unless the case names a device."""
    from buzzdetect_torch import analysis
    kw.setdefault('device', 'cpu')
    return analysis.analyze(**kw)


CLASSES = ['ins_buzz', 'ambient_noise', 'mech_hum']


@pytest.fixture(scope='module')
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp('sumenv')
    build_model_bundle(str(root / 'models' / 'summodel'), classes=CLASSES,
                       seed=11)
    dir_audio = root / 'audio'
    dir_audio.mkdir()
    write_wav(dir_audio / 'tone.wav', make_tone(4.0, 16000, 220), 16000)
    return {'models': str(root / 'models'), 'audio': str(dir_audio)}


@pytest.fixture()
def patched(env, monkeypatch):
    monkeypatch.setattr(cfg, 'DIR_MODELS', env['models'])
    return env


def _read_summary(dir_out):
    with open(os.path.join(dir_out, cfg.FNAME_RUN_SUMMARY)) as f:
        return json.load(f)


def test_summary_on_completed_run(patched, tmp_path):
    dir_out = str(tmp_path / 'out')
    analyze(modelname='summodel', dir_audio=patched['audio'],
            dir_out=dir_out, chunklength=2.0, verbosity_print='ERROR')
    s = _read_summary(dir_out)
    assert s['schema'] == 'buzzdetect_run_summary/1'
    assert s['end_reason'] == 'completed' and s['ok'] is True
    assert s['modelname'] == 'summodel'
    assert s['classes_out'] == CLASSES
    assert s['files_finalized'] == 1
    assert s['files_failed'] == []
    assert s['chunks'] >= 2  # 4 s at 2 s (-> 1.92 s) chunks
    assert s['audio_seconds'] > 0
    assert s['rate_realtime'] > 0 and s['wall_s'] > 0
    assert s['started'] <= s['finished']  # ISO strings sort temporally
    assert s['watch'] is False and s['host_shard'] is None
    # no tmp residue from the atomic replace
    assert not os.path.exists(
        os.path.join(dir_out, cfg.FNAME_RUN_SUMMARY + '.tmp'))


def test_summary_fully_analyzed_rerun(patched, tmp_path):
    dir_out = str(tmp_path / 'out')
    kw = dict(modelname='summodel', dir_audio=patched['audio'],
              dir_out=dir_out, chunklength=2.0, verbosity_print='ERROR')
    analyze(**kw)
    analyze(**kw)
    s = _read_summary(dir_out)
    # the rerun's outcome replaced the first run's
    assert s['end_reason'] in ('fully analyzed', 'completed')
    assert s['ok'] is True
    assert s['files_finalized'] == 0 and s['chunks'] == 0


def test_summary_records_failed_files(patched, tmp_path):
    """A garbage container doesn't end the run abnormally (other files
    complete), but the summary must name it — files_failed is the
    per-file health signal the end_reason deliberately isn't."""
    dir_audio = str(tmp_path / 'audio')
    os.makedirs(dir_audio)
    write_wav(os.path.join(dir_audio, 'good.wav'), make_tone(2.0, 16000),
              16000)
    with open(os.path.join(dir_audio, 'garbage.wav'), 'wb') as f:
        f.write(os.urandom(20000))
    dir_out = str(tmp_path / 'out')
    analyze(modelname='summodel', dir_audio=dir_audio, dir_out=dir_out,
            chunklength=2.0, verbosity_print='ERROR')
    s = _read_summary(dir_out)
    assert s['end_reason'] == 'completed' and s['ok'] is True
    assert s['files_failed'] == ['garbage']
    assert s['files_finalized'] == 1


def test_summary_on_manifest_mismatch(patched, tmp_path):
    dir_out = str(tmp_path / 'out')
    kw = dict(modelname='summodel', dir_audio=patched['audio'],
              dir_out=dir_out, chunklength=2.0, verbosity_print='ERROR')
    analyze(**kw)
    analyze(framehop_prop=0.5, **kw)
    s = _read_summary(dir_out)
    # the summary describes the most recent run ATTEMPT (telemetry),
    # while the manifest remains the archive's provenance record
    assert s['end_reason'] == 'manifest mismatch' and s['ok'] is False
    assert s['files_finalized'] == 0
    assert s['framehop_prop'] == 0.5


def test_summary_write_failure_never_masks_the_run(patched, tmp_path,
                                                   monkeypatch):
    """A summary that cannot be written (full disk, read-only dir_out)
    logs a warning; it must never replace the run's real outcome with
    an IOError."""
    monkeypatch.setattr(cfg, 'FNAME_RUN_SUMMARY', 'x' * 300 + '.json')
    dir_out = str(tmp_path / 'out')
    a = analyze(modelname='summodel', dir_audio=patched['audio'],
                dir_out=dir_out, chunklength=2.0, verbosity_print='ERROR')
    assert a.coordinator.end_reason == 'completed'
    assert os.path.exists(os.path.join(dir_out, 'tone_buzzdetect.csv'))


def test_summary_host_tagged_in_multi_host_runs(patched, tmp_path):
    """Hosts share one dir_out (the host_shard deployment), so each must
    write its OWN summary — a late healthy host clobbering an unhealthy
    one's outcome would blind the supervisor to the unanalyzed shard."""
    dir_out = str(tmp_path / 'out')
    for host in (0, 1):
        analyze(modelname='summodel', dir_audio=patched['audio'],
                dir_out=dir_out, chunklength=2.0, verbosity_print='ERROR',
                host_shard=(host, 2))
    assert not os.path.exists(os.path.join(dir_out, cfg.FNAME_RUN_SUMMARY))
    for host in (0, 1):
        with open(os.path.join(
                dir_out, f'buzzdetect_run_summary_host{host}.json')) as f:
            s = json.load(f)
        assert s['host_shard'] == [host, 2] and s['ok'] is True


def test_summary_running_marker_survives_a_kill(patched, tmp_path,
                                                monkeypatch):
    """SIGKILL/power loss never reach the end-path write; the start-of-run
    marker (end_reason 'running', ok false) must already have replaced
    the previous attempt's ok:true so it can't masquerade as this
    attempt's outcome. Simulated in-process: a crash mid-run leaves
    'crashed: <type>' via the finally; a kill BEFORE that leaves
    'running' — both are not-ok."""
    from buzzdetect_torch import analysis as analysis_mod
    dir_out = str(tmp_path / 'out')
    kw = dict(modelname='summodel', dir_audio=patched['audio'],
              dir_out=dir_out, chunklength=2.0, verbosity_print='ERROR')
    analyze(**kw)
    assert _read_summary(dir_out)['ok'] is True

    # wipe the result so the rerun has real work, then crash it mid-run
    os.remove(os.path.join(dir_out, 'tone_buzzdetect.csv'))

    marker_seen = {}

    def crashing_launch(self):
        marker_seen['summary'] = _read_summary(dir_out)
        raise RuntimeError('device fell off')

    monkeypatch.setattr(analysis_mod.Analyzer, '_launch_writer',
                        crashing_launch)
    with pytest.raises(RuntimeError, match='device fell off'):
        analyze(**kw)
    # at crash time the running marker had replaced the stale ok:true
    assert marker_seen['summary']['end_reason'] == 'running'
    assert marker_seen['summary']['ok'] is False
    assert marker_seen['summary']['finished'] is None
    # and the finally stamped the in-process crash on the way out
    s = _read_summary(dir_out)
    assert s['end_reason'] == 'crashed: RuntimeError' and s['ok'] is False


def test_summary_counts_self_healed_finalization(patched, tmp_path):
    """A rerun that self-heals a finished-but-never-finalized partial
    (SIGKILL between the last append and finalize) produced a complete
    result this run — files_finalized must say so."""
    dir_out = str(tmp_path / 'out')
    kw = dict(modelname='summodel', dir_audio=patched['audio'],
              dir_out=dir_out, chunklength=2.0, verbosity_print='ERROR')
    analyze(**kw)
    # un-finalize: a complete partial that never got promoted
    os.rename(os.path.join(dir_out, 'tone_buzzdetect.csv'),
              os.path.join(dir_out, 'tone_buzzpart.csv'))
    analyze(**kw)
    s = _read_summary(dir_out)
    assert os.path.exists(os.path.join(dir_out, 'tone_buzzdetect.csv'))
    assert s['files_finalized'] == 1 and s['ok'] is True


def test_summary_alert_stats(patched, tmp_path):
    """With a notification hook the summary carries the final dispatch
    counters (the log lines are the human copy); without one it's null."""
    dir_out = str(tmp_path / 'out')
    analyze(modelname='summodel', dir_audio=patched['audio'],
            dir_out=dir_out, chunklength=2.0, verbosity_print='ERROR',
            alert_classes='ins_buzz', alert_threshold=-1e9,
            alert_command='true')
    s = _read_summary(dir_out)
    assert s['alerts'] is not None and s['alerts']['launched'] >= 1
    assert s['alerts']['failures'] == 0

    d2 = str(tmp_path / 'out2')
    analyze(modelname='summodel', dir_audio=patched['audio'],
            dir_out=d2, chunklength=2.0, verbosity_print='ERROR')
    assert _read_summary(d2)['alerts'] is None


def test_summary_each_watch_cycle(patched, tmp_path):
    dir_out = str(tmp_path / 'out')
    analyze(modelname='summodel', dir_audio=patched['audio'],
            dir_out=dir_out, chunklength=2.0, verbosity_print='ERROR',
            watch=True, watch_interval=0.0, watch_cycles=2)
    s = _read_summary(dir_out)
    assert s['watch'] is True and s['ok'] is True
    # each pass replaces the file; the counter says which one this is
    assert s['watch_cycle'] == 2


def test_summary_build_failure_never_masks_the_run(patched, tmp_path,
                                                   monkeypatch):
    """A failure while BUILDING the record — e.g. the failed-streams set
    mutating under a concurrently-draining streamer on an early exit —
    must warn and continue like a write failure, not raise out of _run's
    finally (which would mask the run's real outcome AND skip the lock
    release and logger shutdown after it)."""
    from buzzdetect_torch.runtime.coordination import Coordinator

    def exploding_snapshot(self):
        raise RuntimeError('Set changed size during iteration')

    monkeypatch.setattr(Coordinator, 'failed_streams_snapshot',
                        exploding_snapshot)
    dir_out = str(tmp_path / 'out')
    a = analyze(modelname='summodel', dir_audio=patched['audio'],
                dir_out=dir_out, chunklength=2.0, verbosity_print='ERROR')
    assert a.coordinator.end_reason == 'completed'
    assert os.path.exists(os.path.join(dir_out, 'tone_buzzdetect.csv'))
    # the lock was released despite the summary failure
    assert not os.path.exists(os.path.join(dir_out, cfg.FNAME_LOCK))
    # the warning reached the run log
    logs = [f for f in os.listdir(dir_out) if f.endswith('.log')]
    text = open(os.path.join(dir_out, logs[0])).read()
    assert 'could not build the run summary' in text


def test_summary_carries_writer_pid(patched, tmp_path):
    """The summary names the process that wrote it: a supervisor (and
    the GUI outcome line) can tell ITS run's summary from one written by
    a DIFFERENT live run sharing the folder — a lock-refused attempt
    writes nothing, so the file it finds belongs to the live owner."""
    dir_out = str(tmp_path / 'out')
    analyze(modelname='summodel', dir_audio=patched['audio'],
            dir_out=dir_out, chunklength=2.0, verbosity_print='ERROR')
    assert _read_summary(dir_out)['pid'] == os.getpid()


def test_gui_outcome_skips_a_foreign_summary(tmp_path):
    """The GUI outcome line must ignore a summary written by a DIFFERENT
    pid: when its child was refused by the dir_out lock (which writes no
    summary), the folder holds the live OWNER's 'running' marker — and
    reporting that as 'exited without finishing (killed?)' would
    contradict the refusal message right above it."""
    import time
    import types

    from buzzdetect_torch import config as cfg
    from buzzdetect_torch.gui.analysis import AnalysisWindow

    win = AnalysisWindow.__new__(AnalysisWindow)
    win.analyze_kwargs = {'dir_out': str(tmp_path)}
    win._launched_at = time.time()
    win.process = types.SimpleNamespace(pid=12345)
    lines = []
    win._append = lambda a_log: lines.append(a_log.message)
    path = os.path.join(str(tmp_path), cfg.FNAME_RUN_SUMMARY)
    started = time.strftime('%Y-%m-%d %H:%M:%S')

    # the live owner's start marker: foreign pid, fresh timestamp
    with open(path, 'w') as f:
        json.dump({'end_reason': 'running', 'pid': 99999,
                   'started': started}, f)
    win._append_outcome()
    assert lines == [], lines

    # the SAME file written by our own child: reported as before
    with open(path, 'w') as f:
        json.dump({'end_reason': 'running', 'pid': 12345,
                   'started': started}, f)
    win._append_outcome()
    assert len(lines) == 1 and 'killed' in lines[0]
