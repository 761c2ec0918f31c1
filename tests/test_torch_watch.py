"""Watch mode in the port: live monitoring of a recording directory, on
the CPU (``device='cpu'``).

Mirrors tests/test_watch.py test for test against ``buzzdetect_torch``
(the bundle is made by the port's ``build_model_bundle``). Edits: every run
passes ``device='cpu'``;
``devices=2`` is ``devices=['cpu', 'cpu']`` (two replicas on the one CPU);
the compressed-file test encodes with the port's ``audio.ffi``.

The JAX package's docstring:

Watch mode: live monitoring of a recording directory.

``analyze(watch=True)`` repeatedly rescans ``dir_audio``, analyzing files
that appear between passes and — via the same gap-resume machinery that
powers interrupt/resume — the newly recorded tail of files that grew after
being finalized. (Capability beyond the reference, which is strictly
offline; built on its resume design, `src/stream/worker.py:61-107`.)
"""

import os
import threading
import time

import numpy as np
import pytest

from buzzdetect_torch import analysis as analysis_mod
from buzzdetect_torch import config as cfg
from buzzdetect_torch.models.convert import build_model_bundle
from tests.audio_fixtures import make_tone, write_wav

CLASSES = ['ins_buzz', 'ambient_noise', 'human']


@pytest.fixture(scope='module')
def dir_models(tmp_path_factory):
    root = tmp_path_factory.mktemp('watch_models')
    build_model_bundle(str(root / 'watchmodel'), classes=CLASSES, seed=11)
    return str(root)


@pytest.fixture()
def patched_models(dir_models, monkeypatch):
    monkeypatch.setattr(cfg, 'DIR_MODELS', dir_models)


def analyze(**kw):
    """The port's analyze() on the CPU."""
    return analysis_mod.analyze(device='cpu', **kw)


def _read_rows(path):
    import csv
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], {float(r[0]): [float(v) for v in r[1:]] for r in rows[1:]}


def test_watch_picks_up_new_files(patched_models, tmp_path):
    """A file dropped into the directory between passes gets analyzed."""
    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    dir_out = str(tmp_path / 'out')
    write_wav(dir_audio / 'first.wav', make_tone(2.0, 16000, 220), 16000)

    stop = threading.Event()
    done_first = os.path.join(dir_out, 'first_buzzdetect.csv')
    done_second = os.path.join(dir_out, 'second_buzzdetect.csv')

    def feeder():
        deadline = time.monotonic() + 120
        while not os.path.exists(done_first):
            if time.monotonic() > deadline:
                stop.set()
                return
            time.sleep(0.02)
        write_wav(dir_audio / 'second.wav', make_tone(2.0, 16000, 440), 16000)
        while not os.path.exists(done_second):
            if time.monotonic() > deadline:
                break
            time.sleep(0.02)
        stop.set()

    t = threading.Thread(target=feeder, daemon=True)
    t.start()
    analyze(modelname='watchmodel', dir_audio=str(dir_audio), dir_out=dir_out,
            chunklength=2.0, verbosity_print='ERROR',
            watch=True, watch_interval=0.05, watch_stop=stop)
    t.join(timeout=10)
    assert os.path.exists(done_first)
    assert os.path.exists(done_second), 'new file was not picked up'


def test_watch_analyzes_grown_file_tail(patched_models, tmp_path):
    """A finalized recording that grew is demoted and its tail analyzed; the
    final rows match a from-scratch analysis of the full file — demotion
    drops the seam rows whose pass-1 patch saw zero-padding where the later
    audio now exists, so they are re-scored on real samples. The only
    permitted deviation is at rows whose patch ends at a chunk boundary:
    the final STFT window of every chunk sees a 240-sample (15 ms) zero
    lookahead (inherent to chunked processing, identical in the reference),
    and the two runs chunk the file at different offsets."""
    full = make_tone(6.0, 16000, 330)
    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    dir_out = str(tmp_path / 'out')
    write_wav(dir_audio / 'rec.wav', full[:3 * 16000], 16000)

    analyze(modelname='watchmodel', dir_audio=str(dir_audio), dir_out=dir_out,
            chunklength=2.0, verbosity_print='ERROR')
    path_result = os.path.join(dir_out, 'rec_buzzdetect.csv')
    assert os.path.exists(path_result)
    _, rows_short = _read_rows(path_result)

    # the recorder appends: same prefix, more audio
    write_wav(dir_audio / 'rec.wav', full, 16000)
    a = analyze(modelname='watchmodel', dir_audio=str(dir_audio),
                dir_out=dir_out, chunklength=2.0, verbosity_print='ERROR',
                watch=True, watch_cycles=1)
    assert a.coordinator.end_reason == 'completed'
    assert os.path.exists(path_result)
    assert not os.path.exists(os.path.join(dir_out, 'rec_buzzpart.csv'))
    _, rows_watch = _read_rows(path_result)
    assert len(rows_watch) > len(rows_short), 'tail was not analyzed'

    # oracle: fresh analysis of the full file
    dir_oracle = str(tmp_path / 'oracle_out')
    analyze(modelname='watchmodel', dir_audio=str(dir_audio),
            dir_out=dir_oracle, chunklength=2.0, verbosity_print='ERROR')
    _, rows_fresh = _read_rows(os.path.join(dir_oracle, 'rec_buzzdetect.csv'))

    assert set(rows_watch) == set(rows_fresh), 'row starts differ from oracle'
    # chunk boundaries of the two runs (chunklength 2.0 rounds to 1.92 s;
    # the watch pass re-chunks from the demoted coverage end)
    framelength = 0.96
    boundaries = {round(k * 1.92, 2) for k in range(1, 4)} | {2.88, 4.8}
    for s in rows_fresh:
        tol = 0.011
        if any(abs((s + framelength) - b) < 1e-6 for b in boundaries):
            tol = 0.05  # chunk-final row: 15 ms zero lookahead differs
        np.testing.assert_allclose(rows_watch[s], rows_fresh[s], atol=tol,
                                   err_msg=f'row {s} differs from oracle')


def test_watch_survives_gui_done_event(patched_models, tmp_path):
    """The pipeline sets event_stopanalysis at the end of every pass (the
    'analysis done' GUI signal); watch cycles therefore run on fresh
    internal events — otherwise the stale completion signal reads as a
    stop request and kills the watcher after one pass."""
    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    write_wav(dir_audio / 'rec.wav', make_tone(2.0, 16000, 220), 16000)
    ev = threading.Event()
    a = analyze(modelname='watchmodel', dir_audio=str(dir_audio),
                dir_out=str(tmp_path / 'out'), chunklength=2.0,
                verbosity_print='ERROR', event_stopanalysis=ev,
                watch=True, watch_cycles=3, watch_interval=0.01)
    # pre-fix this was 'interrupted' on cycle 2 and the loop broke early
    assert a.coordinator.end_reason == 'fully analyzed'


def test_watch_external_stop_ends_watcher(patched_models, tmp_path):
    """A genuine external stop (the GUI stop button's event) must end the
    watch loop promptly — including from the idle sleep between passes."""
    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    write_wav(dir_audio / 'rec.wav', make_tone(2.0, 16000, 220), 16000)
    ev = threading.Event()
    done = os.path.join(str(tmp_path / 'out'), 'rec_buzzdetect.csv')

    def stopper():
        deadline = time.monotonic() + 120
        while not os.path.exists(done) and time.monotonic() < deadline:
            time.sleep(0.02)
        time.sleep(0.1)  # let the watcher reach its idle sleep
        ev.set()

    t = threading.Thread(target=stopper, daemon=True)
    t.start()
    t0 = time.monotonic()
    analyze(modelname='watchmodel', dir_audio=str(dir_audio),
            dir_out=str(tmp_path / 'out'), chunklength=2.0,
            verbosity_print='ERROR', event_stopanalysis=ev,
            watch=True, watch_interval=3600)  # would sleep an hour w/o stop
    assert time.monotonic() - t0 < 60, 'external stop did not end the watch'
    assert os.path.exists(done)


def test_watch_transient_error_retries_next_cycle(patched_models, tmp_path,
                                                  monkeypatch):
    """A transient IO error while re-examining a grown file must NOT commit
    the new stat signature — the next cycle retries and analyzes the tail."""
    from buzzdetect_torch import audio as audio_mod
    full = make_tone(6.0, 16000, 330)
    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    dir_out = str(tmp_path / 'out')
    write_wav(dir_audio / 'rec.wav', full[:3 * 16000], 16000)
    analyze(modelname='watchmodel', dir_audio=str(dir_audio), dir_out=dir_out,
            chunklength=2.0, verbosity_print='ERROR')
    write_wav(dir_audio / 'rec.wav', full, 16000)  # grows, then never again

    real_build_track = audio_mod.build_track
    calls = {'n': 0}

    def flaky(path, **kw):
        calls['n'] += 1
        if calls['n'] == 1:
            raise OSError('simulated transient read failure')
        return real_build_track(path, **kw)

    monkeypatch.setattr(audio_mod, 'build_track', flaky)
    a = analyze(modelname='watchmodel', dir_audio=str(dir_audio),
                dir_out=dir_out, chunklength=2.0, verbosity_print='ERROR',
                watch=True, watch_cycles=2, watch_interval=0.01)
    _, rows = _read_rows(os.path.join(dir_out, 'rec_buzzdetect.csv'))
    assert max(rows) > 3.0, 'tail never analyzed after transient error'
    assert a.coordinator.end_reason == 'completed'


def test_watch_static_files_left_alone(patched_models, tmp_path):
    """Idle passes never touch finalized results — including a file whose
    coverage is incomplete but whose bytes haven't changed (e.g. finalized
    early over a corrupt tail): it is re-examined at most once."""
    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    dir_out = str(tmp_path / 'out')
    write_wav(dir_audio / 'rec.wav', make_tone(2.0, 16000, 220), 16000)
    analyze(modelname='watchmodel', dir_audio=str(dir_audio), dir_out=dir_out,
            chunklength=2.0, verbosity_print='ERROR')
    path_result = os.path.join(dir_out, 'rec_buzzdetect.csv')
    before = open(path_result).read()

    a = analyze(modelname='watchmodel', dir_audio=str(dir_audio),
                dir_out=dir_out, chunklength=2.0, verbosity_print='ERROR',
                watch=True, watch_cycles=3, watch_interval=0.01)
    assert a.coordinator.end_reason == 'fully analyzed'
    assert open(path_result).read() == before
    # the stat signature is cached, so later passes skip even the re-check
    assert str(dir_audio / 'rec.wav') in a.watch_state


def test_watch_state_prunes_deleted_files(patched_models, tmp_path):
    """Rotated/deleted recordings must not pin watch-state entries forever
    (a week-long watcher over a rotating recorder would leak otherwise)."""
    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    dir_out = str(tmp_path / 'out')
    write_wav(dir_audio / 'a.wav', make_tone(2.0, 16000, 220), 16000)
    write_wav(dir_audio / 'b.wav', make_tone(2.0, 16000, 440), 16000)

    stop = threading.Event()
    rotated = {'done': False}

    def rotator():
        deadline = time.monotonic() + 120
        while not (os.path.exists(os.path.join(dir_out, 'a_buzzdetect.csv'))
                   and os.path.exists(
                       os.path.join(dir_out, 'b_buzzdetect.csv'))):
            if time.monotonic() > deadline:
                stop.set()
                return
            time.sleep(0.02)
        os.remove(dir_audio / 'a.wav')
        rotated['done'] = True
        # several pass intervals so the pruning pass actually runs
        # post-delete, with margin for a loaded CI host (the pass itself
        # is a cheap scan: every file is already complete)
        time.sleep(1.0)
        stop.set()

    t = threading.Thread(target=rotator, daemon=True)
    t.start()
    a = analyze(modelname='watchmodel', dir_audio=str(dir_audio),
                dir_out=dir_out, chunklength=2.0, verbosity_print='ERROR',
                watch=True, watch_interval=0.05, watch_stop=stop)
    t.join(timeout=10)
    assert rotated['done']
    assert str(dir_audio / 'a.wav') not in a.watch_state
    assert str(dir_audio / 'b.wav') in a.watch_state


def test_watch_empty_directory_waits_quietly(patched_models, tmp_path):
    """Watching an empty directory (recorder not started yet) just idles."""
    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    a = analyze(modelname='watchmodel', dir_audio=str(dir_audio),
                dir_out=str(tmp_path / 'out'), verbosity_print='ERROR',
                watch=True, watch_cycles=2, watch_interval=0.01)
    assert a.coordinator.end_reason == 'no files'


def test_cli_exposes_watch_flags():
    from buzzdetect_torch.cli import build_parser
    args = build_parser().parse_args(
        ['--modelname', 'm', '--watch', '--watch_interval', '5'])
    assert args.watch is True
    assert args.watch_interval == 5.0
    args = build_parser().parse_args(['--modelname', 'm'])
    assert args.watch is False


def test_watch_stops_on_fatal_failure(tmp_path, monkeypatch):
    """A fatal worker failure must END the watch loop — retrying would fail
    identically every cycle, spamming errors forever."""

    # metadata loads fine; the weights blob is garbage, so the analyzer's
    # initialize() dies in its worker thread (the fatal-death path)
    dir_models = tmp_path / 'models'
    broken = dir_models / 'bk'
    broken.mkdir(parents=True)
    (broken / 'config_model.json').write_text(
        '{"classes": ["ins_buzz"], "embeddername": "yamnet"}')
    (broken / 'model.npz').write_text('garbage-not-npz')
    monkeypatch.setattr(cfg, 'DIR_MODELS', str(dir_models))

    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    write_wav(dir_audio / 'rec.wav', make_tone(2.0, 16000), 16000)

    result = {}

    def run():
        result['analyzer'] = analyze(
            modelname='bk', dir_audio=str(dir_audio),
            dir_out=str(tmp_path / 'out'), verbosity_print='CRITICAL',
            watch=True, watch_interval=0.2, watch_cycles=5)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=90)
    assert not t.is_alive(), 'watch loop kept retrying a fatal failure'
    assert result['analyzer'].coordinator.end_reason == 'analyzer failure'


def test_watch_endurance_bounded_residue(patched_models, tmp_path):
    """100+ watch cycles must leave no per-cycle residue: the watcher loops
    one_pass() per cycle, so a single leaked thread, file handle, or
    watch_state entry per pass compounds into an unbounded long-running
    monitor (tools/soak_watch.py is the heavier rotating-corpus variant)."""
    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    for i in range(2):
        write_wav(dir_audio / f'f{i}.wav', make_tone(2.0, 16000, 220 + 80 * i),
                  16000)
    # live alerts + notification hook included: each cycle spins an
    # AlertCommandRunner dispatcher thread that must exit with its pass
    kw = dict(modelname='watchmodel', dir_audio=str(dir_audio),
              dir_out=str(tmp_path / 'out'), chunklength=2.0,
              verbosity_print='ERROR', watch=True, watch_interval=0.0,
              alert_classes='ins_buzz', alert_threshold=-1e9,
              alert_command='true')

    analyze(watch_cycles=5, **kw)  # steady state: compiled, corpus analyzed
    have_proc = os.path.exists('/proc/self/fd')
    base_threads = threading.active_count()
    base_fds = len(os.listdir('/proc/self/fd')) if have_proc else 0

    analyzer = analyze(watch_cycles=110, **kw)

    assert threading.active_count() - base_threads <= 2, \
        'watcher/worker threads accumulated across cycles'
    if have_proc:
        assert len(os.listdir('/proc/self/fd')) - base_fds <= 5, \
            'file descriptors accumulated across cycles (logger handles?)'
    assert analyzer.watch_state is not None
    assert len(analyzer.watch_state) <= 2, \
        'watch_state grew beyond the files on disk'


def test_watch_shares_replica_models_across_cycles(patched_models, tmp_path,
                                                   monkeypatch):
    """watch + devices: every cycle must reuse the SAME replica set (params
    and compiled programs upload once, not once per polling cycle), and
    results must match a plain single-device run."""
    captured = []
    orig = analysis_mod.Analyzer

    class SpyAnalyzer(orig):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            captured.append(self.replica_models)

    monkeypatch.setattr(analysis_mod, 'Analyzer', SpyAnalyzer)

    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    write_wav(dir_audio / 'w.wav', make_tone(2.0, 16000, 260), 16000)

    analyze(modelname='watchmodel', dir_audio=str(dir_audio),
            dir_out=str(tmp_path / 'watched'), chunklength=2.0,
            verbosity_print='ERROR', devices=['cpu', 'cpu'],
            watch=True, watch_interval=0.0, watch_cycles=3)
    assert len(captured) == 3
    assert captured[0] is not None and len(captured[0]) == 2
    ids0 = [id(m) for m in captured[0]]
    assert all([id(m) for m in c] == ids0 for c in captured), \
        'watch cycles rebuilt the replica set instead of sharing it'

    analyze(modelname='watchmodel', dir_audio=str(dir_audio),
            dir_out=str(tmp_path / 'plain'), chunklength=2.0,
            verbosity_print='ERROR')
    got = open(tmp_path / 'watched' / 'w_buzzdetect.csv').read()
    want = open(tmp_path / 'plain' / 'w_buzzdetect.csv').read()
    assert got == want


def test_watch_respects_host_shard(patched_models, tmp_path):
    """watch + host_shard: a watcher only re-examines and demotes grown
    files in ITS shard — another host's grown recording must be left
    untouched (that host's watcher owns it)."""
    from buzzdetect_torch.parallel import shard_files

    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    names = [f'w{i}.wav' for i in range(4)]
    for i, name in enumerate(names):
        write_wav(dir_audio / name, make_tone(2.0, 16000, 220 + 40 * i),
                  16000)
    dir_out = str(tmp_path / 'out')

    # find which files belong to shard 0 vs shard 1
    paths = [str(dir_audio / n) for n in names]
    shard0 = set(shard_files(paths, host_id=0, n_hosts=2,
                             root=str(dir_audio)))
    shard1 = [p for p in paths if p not in shard0]
    assert shard0 and shard1  # the 4-file corpus splits across both

    # both hosts complete their shards (one pass each)
    for host in range(2):
        analyze(modelname='watchmodel', dir_audio=str(dir_audio),
                dir_out=dir_out, chunklength=2.0, verbosity_print='ERROR',
                host_shard=(host, 2), watch=True, watch_interval=0.0,
                watch_cycles=1)
    for name in names:
        assert os.path.exists(os.path.join(
            dir_out, name.replace('.wav', '_buzzdetect.csv')))

    def rows(path):
        return len(open(path).read().splitlines()) - 1

    own = os.path.join(dir_out, os.path.basename(sorted(shard0)[0])
                       .replace('.wav', '_buzzdetect.csv'))
    other = os.path.join(dir_out, os.path.basename(sorted(shard1)[0])
                         .replace('.wav', '_buzzdetect.csv'))
    rows_own_before, rows_other_before = rows(own), rows(other)
    mtime_other_before = os.path.getmtime(other)

    # grow ONE file of each shard; run host 0's watcher only
    for p in (sorted(shard0)[0], sorted(shard1)[0]):
        write_wav(p, make_tone(4.0, 16000, 300), 16000)
    analyze(modelname='watchmodel', dir_audio=str(dir_audio),
            dir_out=dir_out, chunklength=2.0, verbosity_print='ERROR',
            host_shard=(0, 2), watch=True, watch_interval=0.0,
            watch_cycles=2)

    assert rows(own) > rows_own_before, \
        'host 0 must analyze the new tail of its own grown file'
    assert rows(other) == rows_other_before
    assert os.path.getmtime(other) == mtime_other_before, \
        "host 0 must NOT touch the other shard's grown file"


def test_watch_analyzes_grown_compressed_file(patched_models, tmp_path):
    """Field recorders append to COMPRESSED containers too. A grown MP3's
    duration must be re-estimated from the larger container, the finalized
    result demoted, and the tail gap analyzed by seeking into the
    compressed stream — rows must extend past the original coverage and
    the partial must re-finalize."""
    from buzzdetect_torch.audio.ffi import encode_fixture
    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    dir_out = str(tmp_path / 'out')
    first = str(tmp_path / 'first.mp3')
    more = str(tmp_path / 'more.mp3')
    encode_fixture(first, 'libmp3lame', 16000, 1, 3.0)
    encode_fixture(more, 'libmp3lame', 16000, 1, 3.0)
    rec = str(dir_audio / 'rec.mp3')
    with open(rec, 'wb') as f:
        f.write(open(first, 'rb').read())

    analyze(modelname='watchmodel', dir_audio=str(dir_audio),
            dir_out=dir_out, chunklength=2.0, verbosity_print='ERROR')
    path_result = os.path.join(dir_out, 'rec_buzzdetect.csv')
    _, rows_short = _read_rows(path_result)
    assert max(rows_short) < 3.0

    # recorder appends (raw MP3 frames concatenate into a longer stream)
    with open(rec, 'ab') as f:
        f.write(open(more, 'rb').read())
    a = analyze(modelname='watchmodel', dir_audio=str(dir_audio),
                dir_out=dir_out, chunklength=2.0, verbosity_print='ERROR',
                watch=True, watch_cycles=1)
    assert a.coordinator.end_reason == 'completed'
    assert not os.path.exists(os.path.join(dir_out, 'rec_buzzpart.csv'))
    _, rows_watch = _read_rows(path_result)
    assert len(rows_watch) > len(rows_short), 'compressed tail not analyzed'
    assert max(rows_watch) > 3.5  # rows extend into the appended audio
    # the original coverage survived (resume, not re-analysis)
    assert set(rows_short) <= set(rows_watch)


def test_watch_with_live_alerts(patched_models, tmp_path):
    """The headline alert use case: a watch run announces detections in its
    log channel as passes complete (alert config survives the per-cycle
    Analyzer reconstruction)."""
    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    write_wav(dir_audio / 'rec.wav', make_tone(2.0, 16000, 220), 16000)
    dir_out = str(tmp_path / 'out')
    analyze(modelname='watchmodel', dir_audio=str(dir_audio),
            dir_out=dir_out, chunklength=2.0, verbosity_print='ERROR',
            watch=True, watch_cycles=2, watch_interval=0.01,
            alert_classes='ins_buzz', alert_threshold=-1e9)
    text = ''.join(open(os.path.join(dir_out, p)).read()
                   for p in os.listdir(dir_out) if p.endswith('.log'))
    assert 'DETECTED ins_buzz in rec' in text
    assert os.path.exists(os.path.join(dir_out, 'rec_buzzdetect.csv'))


def test_watch_startup_warnings_announce_once(patched_models, tmp_path):
    """Setup-time warnings (e.g. an alert class the archive won't record)
    reach the log channel ONCE per watch run, not once per polling cycle —
    each cycle rebuilds the Analyzer, and without the quiet_startup gate
    the identical WARNING would repeat every interval for the watcher's
    lifetime."""
    import warnings as _warnings

    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    write_wav(dir_audio / 'rec.wav', make_tone(2.0, 16000, 220), 16000)
    dir_out = str(tmp_path / 'out')
    with _warnings.catch_warnings():
        _warnings.simplefilter('ignore')  # the API-path copy, tested below
        analyze(modelname='watchmodel', dir_audio=str(dir_audio),
                dir_out=dir_out, chunklength=2.0, verbosity_print='ERROR',
                classes_out=['human'],  # ins_buzz NOT archived -> warning
                watch=True, watch_cycles=3, watch_interval=0.01,
                alert_classes='ins_buzz', alert_threshold=-1e9)
    text = ''.join(open(os.path.join(dir_out, p)).read()
                   for p in os.listdir(dir_out) if p.endswith('.log'))
    assert text.count('not archived in the result files') == 1
    # the alert itself still fires every cycle that lands new audio
    assert 'DETECTED ins_buzz in rec' in text


def test_watch_stops_when_manifest_vanishes(patched_models, tmp_path):
    """The manifest disappearing mid-watch (operator cleanup, rsync
    mishap) turns the output folder into orphaned results — the next
    pass refuses admission, and the watch loop must STOP on that
    refusal instead of retrying the identical failure every cycle."""
    import threading as _threading
    from buzzdetect_torch.manifest import FNAME_MANIFEST

    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    dir_out = tmp_path / 'out'
    write_wav(dir_audio / 'rec.wav', make_tone(2.0, 16000, 220), 16000)

    done = os.path.join(dir_out, 'rec_buzzdetect.csv')
    stop = _threading.Event()

    def saboteur():
        deadline = time.monotonic() + 120
        while not os.path.exists(done):
            if time.monotonic() > deadline:
                stop.set()
                return
            time.sleep(0.02)
        os.remove(os.path.join(dir_out, FNAME_MANIFEST))

    t = _threading.Thread(target=saboteur, daemon=True)
    t.start()
    a = analyze(modelname='watchmodel', dir_audio=str(dir_audio),
                dir_out=str(dir_out), chunklength=2.0,
                verbosity_print='CRITICAL', watch=True, watch_cycles=10,
                watch_interval=0.05, watch_stop=stop)
    t.join(timeout=10)
    assert a.coordinator.end_reason == 'manifest mismatch'
    # the finalized result from the healthy pass is untouched
    assert os.path.exists(done)


def test_stop_forwarder_catches_a_pass_registered_after_the_stop():
    """The external-stop forwarder must keep signaling until the watch
    loop exits: a stop landing while the NEXT pass's Analyzer is still
    being constructed used to signal the PREVIOUS pass's already-set
    event exactly once and die — the fresh pass then ran its full corpus
    sweep before the loop re-checked the stop flag."""
    from buzzdetect_torch.analysis import _run_stop_forwarder
    from buzzdetect_torch.runtime.coordination import Coordinator

    external, stop, current = threading.Event(), threading.Event(), {}
    t = threading.Thread(target=_run_stop_forwarder,
                         args=(external, stop, current),
                         kwargs={'poll_s': 0.02}, daemon=True)
    t.start()
    external.set()
    deadline = time.time() + 5
    while not stop.is_set() and time.time() < deadline:
        time.sleep(0.01)
    assert stop.is_set()

    # a pass that registers AFTER the one-shot signal fired
    coord = Coordinator(streamers_total=1)
    current['coordinator'] = coord
    assert coord.event_exitanalysis.wait(timeout=5), \
        'late-registered pass was never signaled'

    current['done'] = True  # the loop's finally
    t.join(timeout=5)
    assert not t.is_alive(), 'forwarder left a thread behind'


def test_demote_margin_follows_declared_lookahead(tmp_path):
    """The demotion margin comes from the embedder's DECLARED
    ``lookahead_s`` — and an embedder that declares none gets a
    conservative FULL framelength, not YAMNet's 60 ms.

    The old margin baked ``framelength / 16`` into the demotion for
    every embedder, justified by YAMNet's STFT geometry — an assumption
    the plugin contract nowhere states. A plugin DSP with a longer
    look-ahead (e.g. a 250 ms analysis window) would have kept rows
    whose input included zero padding, baking padded scores into every
    watch-mode seam."""
    import types

    from buzzdetect_torch.analysis import Analyzer
    fl = 0.96
    # a 0.3 s row grid (sparse-framehop-style) whose rows never land
    # exactly ON a cutoff — the demotion keeps an exactly-at-cutoff row
    # by design (its window ends at the old EOF; epsilon guard), so the
    # margins are asserted through strictly-inside rows
    starts = [round(i * 0.3, 2) for i in range(36)]  # 0.0 .. 10.5

    def demote(lookahead):
        path_complete = str(tmp_path / f'r_{lookahead}_buzzdetect.csv')
        path_partial = str(tmp_path / f'r_{lookahead}_buzzpart.csv')
        with open(path_complete, 'w') as f:
            f.write('start,activation_x\n')
            f.writelines(f'{s},0.5\n' for s in starts)
        a = types.SimpleNamespace(path_results_complete=path_complete,
                                  path_results_partial=path_partial)
        Analyzer._demote_to_partial(a, fl, lookahead)
        with open(path_partial) as f:
            kept = [float(r.split(',')[0]) for r in f.read().splitlines()[1:]]
        return kept

    # YAMNet's declared 60 ms tail: cutoff = 10.5 - 0.96 - 0.06 = 9.48
    # -> last kept row 9.3
    assert demote(0.06) == starts[:32]

    # undeclared (None): conservative full framelength — cutoff
    # 10.5 - 1.92 = 8.58 -> last kept row 8.4 (the old margin's 9.48
    # cutoff would have KEPT 8.7-9.3, rows a long-lookahead plugin DSP
    # may have scored against zero padding)
    assert demote(None) == starts[:29]

    # a plugin declaring a LONG tail drops everything its DSP could have
    # padded: cutoff 10.5 - 0.96 - 2.5 = 7.04 -> last kept row 6.9
    assert demote(2.5) == starts[:24]

    # and the builtin embedder actually declares the tight value while the
    # base contract leaves it undeclared
    from buzzdetect_torch.models.registry import BaseEmbedder, EmbedderYamnet
    assert BaseEmbedder.lookahead_s is None
    assert EmbedderYamnet.lookahead_s == pytest.approx(0.06)


def test_demote_tolerates_debris_rows(patched_models, tmp_path):
    """A finalized CSV carrying a blank or hand-damaged line (the result
    contract allows files the reference wrote or a human touched) must
    still demote when its recording grows — the hand-rolled parser used
    to raise on float(''), and because the stat signature is recorded
    only after success, the watcher re-warned on the identical file
    every cycle forever while never analyzing the new tail."""
    full = make_tone(6.0, 16000, 330)
    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    dir_out = str(tmp_path / 'out')
    write_wav(dir_audio / 'rec.wav', full[:3 * 16000], 16000)
    analyze(modelname='watchmodel', dir_audio=str(dir_audio),
            dir_out=dir_out, chunklength=2.0, verbosity_print='ERROR')
    path_result = os.path.join(dir_out, 'rec_buzzdetect.csv')
    _, rows_short = _read_rows(path_result)

    # debris: a blank line and a non-numeric line mid-file
    lines = open(path_result).read().splitlines()
    lines.insert(2, '')
    lines.insert(3, 'not,a,result,row')
    with open(path_result, 'w') as f:
        f.write('\n'.join(lines) + '\n')

    write_wav(dir_audio / 'rec.wav', full, 16000)
    a = analyze(modelname='watchmodel', dir_audio=str(dir_audio),
                dir_out=dir_out, chunklength=2.0, verbosity_print='ERROR',
                watch=True, watch_cycles=1)
    assert a.coordinator.end_reason == 'completed'
    _, rows_watch = _read_rows(path_result)
    assert len(rows_watch) > len(rows_short), 'tail was not analyzed'


def test_soak_watch_tool_bounds_residue(capsys):
    """The port's soak tool (buzzdetect_torch/tools/soak_watch.py) on the
    CPU, briefly, in replica mode (``--devices 1``): the corpus grows,
    gains and rotates files under the watcher, and the residue stays
    bounded (exit 0)."""
    from buzzdetect_torch.tools import soak_watch
    soak_watch.main(['--cycles', '6', '--warm-cycles', '1', '--device',
                     'cpu', '--devices', '1'])
    out = capsys.readouterr().out
    print(out)
    assert 'PASS: residue bounded' in out
