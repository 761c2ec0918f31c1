"""tests/test_runtime_hardening.py, case for case, against ``buzzdetect_torch``
(import prefix changed, same assertions). Edits: every run is the port's
``analyze()`` on ``device='cpu'`` (the module's ``analyze`` wrapper;
``Analyzer(device='cpu')`` where a case builds one); ``devices=2`` and
``devices=4`` name the CPU two and four times (the JAX cases count 8 virtual
CPU devices); the two execution-target cases read torch's default device and
a ``torch.device`` pin, and build their meshes by repeating the CPU (their
docstrings say so).

The JAX package's docstring:

Regression tests for runtime hardening (round-2 VERDICT items):

- the early-exit watcher thread must terminate after a completed run
  (no daemon-thread accumulation for library callers looping analyze()),
- the inferer batch error path must deliver EVERY not-yet-written chunk to
  the writer, including chunks whose results were already assigned when the
  exception landed (the `delivered` flag, not `results is None`).
"""

import queue
import threading
import time

import pytest

import numpy as np

from buzzdetect_torch.runtime.assignments import AssignChunk, AssignFile
from buzzdetect_torch.runtime.coordination import Coordinator
from buzzdetect_torch.runtime.inferer import WorkerInferer


def analyze(**kw):
    """The port's analyze(), on the CPU unless the case names a device."""
    from buzzdetect_torch import analysis
    kw.setdefault('device', 'cpu')
    return analysis.analyze(**kw)


WATCHER_NAMES = ('watch_workers', 'watch_earlyexit', 'watch_event')


def _alive_watchers():
    return [t.name for t in threading.enumerate() if t.name in WATCHER_NAMES]


def test_watcher_threads_exit_after_completion():
    """All three wait_for_exit watchers must terminate on normal completion —
    in particular watch_earlyexit, which used to block forever on
    q_earlyexit.get() (leaked one daemon thread per analyze() call)."""
    coord = Coordinator(streamers_total=1)
    dummies = [threading.Thread(target=lambda: None) for _ in range(3)]
    for t in dummies:
        t.start()
    coord.wait_for_exit(threads_streamers=[dummies[0]],
                        threads_analyzers=[dummies[1]],
                        thread_writer=dummies[2])
    assert coord.end_reason == 'completed'
    deadline = time.time() + 10
    while time.time() < deadline and _alive_watchers():
        time.sleep(0.05)
    assert _alive_watchers() == []


def test_watcher_threads_exit_after_early_stop():
    """Same guarantee when the run is stopped via the event channel."""
    coord = Coordinator(streamers_total=1)
    release = threading.Event()
    workers = [threading.Thread(target=release.wait) for _ in range(3)]
    for t in workers:
        t.start()
    done = threading.Event()

    def waiter():
        coord.wait_for_exit(threads_streamers=[workers[0]],
                            threads_analyzers=[workers[1]],
                            thread_writer=workers[2])
        done.set()

    threading.Thread(target=waiter, daemon=True).start()
    coord.event_exitanalysis.set()  # external stop (GUI stop button path)
    assert done.wait(timeout=10)
    release.set()
    # drain the poison sentinels so queue state can't wedge the watchers
    deadline = time.time() + 10
    while time.time() < deadline and _alive_watchers():
        time.sleep(0.05)
    assert _alive_watchers() == []
    assert coord.end_reason == 'interrupted'


class FakeEmbedder:
    digits_time = 1


class FakeModel:
    embedder = FakeEmbedder()

    def initialize(self):
        pass

    def predict_async(self, samples):
        return np.zeros((1, 2), np.float32), 1

    def predict_async_batch(self, samples_list):
        n = len(samples_list)
        return [np.zeros((1, 2), np.float32)] * n, [1] * n


class FakeCoordinator:
    def __init__(self, chunks, fail_first_put=0):
        self.q_log = queue.Queue()
        self.q_analyze = queue.Queue()
        for c in chunks:
            self.q_analyze.put(c)
        self.q_analyze.put('exit')
        self.event_exitanalysis = threading.Event()
        self.written = []
        self._fail_remaining = fail_first_put

    def get_analyze(self):
        return self.q_analyze.get()

    def put_write(self, a_chunk):
        if self._fail_remaining > 0:
            self._fail_remaining -= 1
            raise RuntimeError('injected put_write failure')
        self.written.append(a_chunk)

    def worker_exited(self, kind):
        pass  # protocol hook; exit accounting is the real Coordinator's job


def _chunk(ident, span):
    f = AssignFile(path_audio=f'/tmp/{ident}.wav', dir_audio='/tmp',
                   dir_results='/tmp/out')
    return AssignChunk(file=f, chunk=span,
                       samples=np.zeros(16, np.float32))


def test_inferer_batch_error_delivers_results_bearing_chunks():
    """An exception landing AFTER a chunk's results were assigned but BEFORE
    its put_write must still deliver that chunk to the writer exactly once
    (the old `results is None` filter stranded it forever)."""
    chunks = [_chunk('a', (0.0, 1.0)), _chunk('b', (0.0, 1.0))]
    coord = FakeCoordinator(chunks, fail_first_put=1)
    w = WorkerInferer(id_analyzer=0, model=FakeModel(), coordinator=coord,
                      batch_chunks=2)
    w.run()
    # both chunks reach the writer despite the injected failure; the first
    # (results already assigned when put_write blew up) keeps its results
    assert len(coord.written) == 2
    assert {id(c) for c in coord.written} == {id(c) for c in chunks}
    assert all(c.delivered for c in chunks)


def test_drain_batch_budget_counts_mixed_rates():
    """Different-rate chunks count toward the drain budget: a mixed-rate
    corpus must not let _drain_batch sweep the whole bounded prefetch ring
    into its unbounded worker-local `mixed` list."""
    first = _chunk('a', (0.0, 1.0))
    first.input_rate = 16000
    others = []
    for i in range(12):
        c = _chunk(f'm{i}', (0.0, 1.0))
        c.input_rate = 48000  # never matches `first`
        others.append(c)
    coord = FakeCoordinator(others)
    w = WorkerInferer(id_analyzer=0, model=FakeModel(), coordinator=coord,
                      batch_chunks=4)
    batch, leftover, exit_seen = w._drain_batch(first)
    drained = len(batch) + len(leftover)
    # budget is batch_chunks (4): first + at most 3 drained items; the
    # other 9 mixed-rate chunks stay in the bounded ring
    assert drained <= 4
    assert coord.q_analyze.qsize() >= 9
    assert not exit_seen


def test_worker_exit_events_set_by_workers_not_joins():
    """The stage-done events gate put_write's and _poison's bail-outs; they
    must be set by the workers themselves on exit. If only wait_for_exit's
    watcher set them (after joining those very workers), an early exit
    could livelock an analyzer spinning put_write against a full,
    consumer-less q_write."""
    import threading
    import time
    from buzzdetect_torch.runtime.coordination import Coordinator
    from buzzdetect_torch.runtime.writer import WorkerWriter

    coord = Coordinator(analyzers_cpu=1, streamers_total=1)
    w = WorkerWriter(classes_out=['a'], threshold=None, classes=['a'],
                     framehop_s=0.96, digits_time=2, digits_results=2,
                     coordinator=coord)
    t = threading.Thread(target=w, daemon=True)
    t.start()
    coord.q_write.put('exit')
    t.join(timeout=10)
    assert not t.is_alive()
    assert coord.writer_done.is_set(), \
        'writer must signal its own exit (nobody joined it)'

    # q_write full and the writer gone: put_write must return promptly
    while True:
        try:
            coord.q_write.put_nowait(object())
        except Exception:
            break
    t0 = time.monotonic()
    coord.put_write(object())
    assert time.monotonic() - t0 < 5.0, 'put_write livelocked'


def test_degenerate_worker_sizing_rejected():
    """0 workers silently produced a no-op 'Analysis complete' and
    queue.Queue(maxsize=0) is UNBOUNDED — both must be loud errors."""
    import pytest
    from buzzdetect_torch.runtime.coordination import Coordinator
    with pytest.raises(ValueError):
        Coordinator(streamers_total=0)
    with pytest.raises(ValueError):
        Coordinator(depth=0)
    with pytest.raises(ValueError):
        Coordinator(analyzers_cpu=0, analyzers_gpu=0)


def test_external_stop_under_contention_never_hangs(tmp_path, monkeypatch):
    """Protocol stress: many files, several streamers, and an external stop
    fired at a random moment must always return promptly (no livelock of a
    producer against a poisoned queue) and leave a resumable state that a
    follow-up run completes."""
    import threading
    import time
    from buzzdetect_torch import config as cfg
    from buzzdetect_torch.models.convert import build_model_bundle
    from tests.audio_fixtures import make_tone, write_wav

    dir_models = tmp_path / 'models'
    build_model_bundle(str(dir_models / 'sm'), classes=['ins_buzz', 'x'],
                       seed=3)
    monkeypatch.setattr(cfg, 'DIR_MODELS', str(dir_models))

    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    for i in range(12):
        write_wav(dir_audio / f'f{i}.wav', make_tone(3.0, 16000, 200 + i),
                  16000)
    dir_out = str(tmp_path / 'out')

    for delay in (0.05, 0.4, 1.5):
        stop = threading.Event()
        threading.Timer(delay, stop.set).start()
        t0 = time.monotonic()
        analyze(modelname='sm', dir_audio=str(dir_audio), dir_out=dir_out,
                chunklength=1.0, n_streamers=4, stream_buffer_depth=2,
                event_stopanalysis=stop, verbosity_print='ERROR')
        assert time.monotonic() - t0 < 120, 'stopped run failed to return'

    # a clean follow-up run completes everything the stops left behind
    a = analyze(modelname='sm', dir_audio=str(dir_audio), dir_out=dir_out,
                chunklength=1.0, n_streamers=4, verbosity_print='ERROR')
    assert a.coordinator.end_reason in ('completed', 'fully analyzed')
    import os
    done = [f for f in os.listdir(dir_out) if f.endswith('_buzzdetect.csv')]
    assert len(done) == 12
    assert not [f for f in os.listdir(dir_out) if f.endswith('_buzzpart.csv')]


def test_fatal_analyzer_death_stops_run_instead_of_hanging(tmp_path):
    """A model whose initialize() raises kills the analyzer thread before
    its loop starts. With a corpus bigger than the prefetch ring, the
    streamers used to spin forever against the full consumer-less queue
    (hanging analyze()); the death must instead trigger the exit protocol
    with a loud ERROR and a resumable state."""
    from buzzdetect_torch.analysis import Analyzer
    from tests.audio_fixtures import make_tone, write_wav

    class BrokenEmbedder:
        framelength_s = 0.96
        digits_time = 2
        samplerate = 16000
        framehop_s = 0.96
        framehop_prop = 1.0

    class BrokenModel:
        embedder = BrokenEmbedder()
        config = {'classes': ['ins_buzz', 'x']}

        def initialize(self):
            raise RuntimeError('simulated fatal model-load failure')

        def predict(self, samples):
            raise AssertionError('never reached')

    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    for i in range(4):
        write_wav(dir_audio / f'f{i}.wav', make_tone(4.0, 16000), 16000)

    coord = Coordinator(streamers_total=2, depth=2)
    an = Analyzer(modelname='broken', model=BrokenModel(),
                  dir_audio=str(dir_audio), dir_out=str(tmp_path / 'out'),
                  chunklength=1.0, coordinator=coord,
                  verbosity_print='CRITICAL')
    t = threading.Thread(target=an.run, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), 'analyze() hung after fatal analyzer death'
    assert coord.end_reason == 'analyzer failure'
    import os
    assert not [f for f in os.listdir(tmp_path / 'out')
                if f.endswith('_buzzdetect.csv')], \
        'nothing was analyzed; nothing may be marked complete'


def test_truncated_read_end_uses_embedder_time_precision():
    """The shortened chunk end after a truncated read must round with the
    embedder's digits_time, not a hardcoded 2 — identical at the default
    precision, a latent timestamp/coverage mismatch for any embedder with
    finer time resolution (reference src/stream/worker.py:41-59 semantics,
    generalized)."""
    from buzzdetect_torch.runtime.streamer import WorkerStreamer

    class Embedder4:
        digits_time = 4
        framelength_s = 0.96
        framehop_s = 0.96
        samplerate = 16000

    class Model4:
        embedder = Embedder4()
        transfer_dtype = 'float32'

    class ShortTrack:
        samplerate = 16000

        def seek(self, n):
            pass

        def read(self, n, dtype=None):
            return np.zeros(12345, np.float32)  # short read: file truncated

        def tell(self):
            return 12345

    class Coord:
        def __init__(self):
            self.q_log = queue.Queue()
            self.puts = []
            self.event_exitanalysis = threading.Event()

        def put_analyze(self, c):
            self.puts.append(c)

        def mark_stream_finished(self, ident):
            pass

        def mark_stream_failed(self, ident):
            pass

    coord = Coord()
    s = WorkerStreamer(0, Model4(), chunklength=2.0, coordinator=coord)
    f = AssignFile(path_audio='/tmp/t.wav', dir_audio='/tmp',
                   dir_results='/tmp/out')
    f.track = ShortTrack()
    f.duration_audio = 2.0
    f.has_results = True  # not the first-read-of-fresh-file failure path
    cont = s.queue_chunk(f, (0.0, 2.0), force_last=True)
    assert not cont, 'a short read stops the file'
    assert len(coord.puts) == 1
    end = coord.puts[0].chunk[1]
    # 12345 / 16000 = 0.7715625 -> 0.7716 at digits_time=4 (0.77 would mean
    # the hardcoded 2-decimal round regressed back in)
    assert end == round(12345 / 16000, 4) == 0.7716


def test_early_exit_mid_file_marks_stream_failed():
    """An exit request mid-file must mark the stream FAILED (resumable
    partial), not finished: with chunks never queued, 'finished' lets the
    writer promote a truncated partial to a permanent complete result the
    moment the already-queued chunks drain — silent data loss on every
    interrupted run, invisible to later runs (they skip complete files)."""
    from buzzdetect_torch.runtime.streamer import WorkerStreamer

    class Embedder:
        digits_time = 2
        framelength_s = 0.96
        framehop_s = 0.96
        samplerate = 16000

    class Model:
        embedder = Embedder()
        transfer_dtype = 'float32'

    class Coord:
        def __init__(self):
            self.q_log = queue.Queue()
            self.finished = []
            self.failed = []
            self.event_exitanalysis = threading.Event()

        def put_analyze(self, c):
            raise AssertionError('no chunk may be queued after exit')

        def mark_stream_finished(self, ident):
            self.finished.append(ident)

        def mark_stream_failed(self, ident):
            self.failed.append(ident)

    coord = Coord()
    coord.event_exitanalysis.set()  # exit lands mid-file
    s = WorkerStreamer(0, Model(), chunklength=2.0, coordinator=coord)
    f = AssignFile(path_audio='/tmp/t.wav', dir_audio='/tmp',
                   dir_results='/tmp/out')
    f.chunklist = [(0.0, 2.0), (2.0, 4.0)]
    s._chunk_file = lambda a_file: None  # chunklist prebuilt above
    s.stream_to_queue(f)
    assert coord.failed == [f.ident], \
        'unqueued chunks must leave the file a resumable partial'
    # mark_stream_failed itself also clears stream_in_progress via
    # mark_stream_finished on the real coordinator; the streamer must not
    # have taken the finished-only path
    assert coord.finished == []


def test_fatal_replica_death_stops_run(tmp_path, monkeypatch):
    """Replica mode: ONE replica failing fatally at initialize must stop the
    whole run loudly (same contract as the shared-model fatal-death path) —
    not hang the other replicas against a drained tracker or promote
    incomplete results."""
    from buzzdetect_torch import config as cfg_mod
    from buzzdetect_torch import analysis as analysis_mod
    from buzzdetect_torch.models.convert import build_model_bundle
    from buzzdetect_torch.models.registry import load_model
    from tests.audio_fixtures import make_tone, write_wav

    dir_models = tmp_path / 'models'
    build_model_bundle(str(dir_models / 'rf'), classes=['a', 'ins_buzz'],
                       seed=3)
    monkeypatch.setattr(cfg_mod, 'DIR_MODELS', str(dir_models))
    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    for i in range(3):
        write_wav(dir_audio / f'f{i}.wav', make_tone(3.0, 16000, 230), 16000)

    real_load = analysis_mod.load_model
    calls = {'n': 0}

    def breaking_load(*a, **kw):
        model = real_load(*a, **kw)
        calls['n'] += 1
        if calls['n'] == 2:  # the SECOND replica is broken
            def boom():
                raise RuntimeError('simulated replica init failure')
            model.initialize = boom
        return model

    monkeypatch.setattr(analysis_mod, 'load_model', breaking_load)
    a = analyze(modelname='rf', dir_audio=str(dir_audio),
                dir_out=str(tmp_path / 'out'), chunklength=2.0,
                devices=['cpu', 'cpu'], verbosity_print='CRITICAL')
    assert a.coordinator.end_reason == 'analyzer failure'
    import os
    done = [f for f in os.listdir(tmp_path / 'out')
            if f.endswith('_buzzdetect.csv')]
    # partial progress (healthy replica) is fine; the run must have ended
    # with the failure surfaced, and a rerun resumes cleanly
    monkeypatch.setattr(analysis_mod, 'load_model', real_load)
    analyze(modelname='rf', dir_audio=str(dir_audio),
            dir_out=str(tmp_path / 'out'), chunklength=2.0,
            verbosity_print='CRITICAL')
    done = [f for f in os.listdir(tmp_path / 'out')
            if f.endswith('_buzzdetect.csv')]
    assert len(done) == 3


def test_external_stop_under_contention_replica_mode(tmp_path, monkeypatch):
    """Exit-protocol stress in REPLICA mode: the coordinator poisons one
    sentinel per analyzer, and replica mode multiplies analyzers — random
    external stops must still return promptly and leave a state a clean
    replica-mode rerun completes."""
    from buzzdetect_torch import config as cfg
    from buzzdetect_torch.models.convert import build_model_bundle
    from tests.audio_fixtures import make_tone, write_wav

    dir_models = tmp_path / 'models'
    build_model_bundle(str(dir_models / 'sr'), classes=['ins_buzz', 'x'],
                       seed=3)
    monkeypatch.setattr(cfg, 'DIR_MODELS', str(dir_models))
    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    for i in range(8):
        write_wav(dir_audio / f'f{i}.wav', make_tone(3.0, 16000, 210 + i),
                  16000)
    dir_out = str(tmp_path / 'out')

    for delay in (0.05, 0.8):
        stop = threading.Event()
        threading.Timer(delay, stop.set).start()
        t0 = time.monotonic()
        analyze(modelname='sr', dir_audio=str(dir_audio), dir_out=dir_out,
                chunklength=1.0, devices=['cpu'] * 4, n_streamers=3,
                stream_buffer_depth=2, event_stopanalysis=stop,
                verbosity_print='ERROR')
        assert time.monotonic() - t0 < 120, 'stopped replica run hung'

    a = analyze(modelname='sr', dir_audio=str(dir_audio), dir_out=dir_out,
                chunklength=1.0, devices=['cpu'] * 4,
                verbosity_print='ERROR')
    assert a.coordinator.end_reason in ('completed', 'fully analyzed')
    import os
    done = [f for f in os.listdir(dir_out) if f.endswith('_buzzdetect.csv')]
    assert len(done) == 8
    assert not [f for f in os.listdir(dir_out) if f.endswith('_buzzpart.csv')]


def test_stall_watchdog_warns_then_stands_down(monkeypatch):
    """Zero results within the budget -> one WARNING pointing at doctor
    (a dead backend hangs the first dispatch silently); progress or
    completion before the budget -> no warning."""
    import queue
    import time
    from buzzdetect_torch import config as cfg
    from buzzdetect_torch.analysis import Analyzer
    from buzzdetect_torch.runtime.coordination import Coordinator

    # generous positive-case window (breaks early the moment the warning
    # lands, so the common case stays ~0.2 s): a loaded CI host must not
    # turn watchdog-thread scheduling delay into a flake
    def drain(coord, seconds=6.0):
        msgs, t0 = [], time.monotonic()
        while time.monotonic() - t0 < seconds:
            try:
                msgs.append(coord.q_log.get(timeout=0.1))
            except queue.Empty:
                if any('no results' in m.message for m in msgs):
                    break
        return [m for m in msgs if 'no results' in m.message]

    monkeypatch.setattr(cfg, 'STALL_WARNING_S', 0.2)

    class Stub:
        stall_timeout = None  # the hard watchdog is opt-in

    # stalled: warns once
    stub = Stub()
    stub.coordinator = Coordinator()
    Analyzer._launch_stall_watchdog(stub)
    warned = drain(stub.coordinator)
    assert len(warned) == 1
    assert warned[0].level_str == 'WARNING'
    assert 'doctor' in warned[0].message

    # progress before the budget: stands down silently
    stub2 = Stub()
    stub2.coordinator = Coordinator()
    stub2.coordinator.audio_seconds_done = 1.0
    Analyzer._launch_stall_watchdog(stub2)
    assert drain(stub2.coordinator, seconds=0.6) == []

    # completed before the budget: stands down silently
    stub3 = Stub()
    stub3.coordinator = Coordinator()
    stub3.coordinator.event_exitanalysis.set()
    Analyzer._launch_stall_watchdog(stub3)
    assert drain(stub3.coordinator, seconds=0.6) == []


def test_stall_timeout_stops_hung_device_mid_run(tmp_path):
    """A dispatch that hangs AFTER progress was made is not a dead worker
    (fatal-death detection never fires) — analyze(stall_timeout=) must end
    the run loudly with checkpoints intact, and a rerun must finish the
    file from exactly where the stall cut it off."""
    import numpy as np
    from buzzdetect_torch import config as cfg
    from buzzdetect_torch.analysis import Analyzer
    from buzzdetect_torch.runtime.coordination import Coordinator
    from tests.audio_fixtures import make_tone, write_wav

    class Emb:
        framelength_s = 0.96
        digits_time = 2
        samplerate = 16000
        framehop_s = 0.96
        framehop_prop = 1.0

    class HangingModel:
        """Scores one chunk, then blocks forever (a dead link mid-run)."""
        embedder = Emb()
        config = {'classes': ['ins_buzz', 'x']}

        def __init__(self, hang_after=1):
            self.calls = 0
            self.hang_after = hang_after
            self.hang = threading.Event()

        def initialize(self):
            pass

        def predict(self, samples):
            self.calls += 1
            if self.hang_after is not None and self.calls > self.hang_after:
                self.hang.wait()  # never set: the blocked-dispatch hang
            n = max(1, int(len(samples) / (0.96 * 16000)))
            return np.full((n, 2), 0.5, np.float32)

    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    write_wav(dir_audio / 'rec.wav', make_tone(6.0, 16000), 16000)
    dir_out = tmp_path / 'out'

    coord = Coordinator(streamers_total=1, depth=1, analyzers_cpu=1)
    an = Analyzer(modelname='hangmodel', model=HangingModel(),
                  dir_audio=str(dir_audio), dir_out=str(dir_out),
                  chunklength=1.0, coordinator=coord,
                  verbosity_print='CRITICAL', stall_timeout=2.0)
    t = threading.Thread(target=an.run, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), 'stall_timeout did not bound the hang'
    assert coord.end_reason == 'device stall'
    # the chunk that completed before the stall is checkpointed
    partial = dir_out / ('rec' + cfg.SUFFIX_RESULT_PARTIAL)
    assert partial.exists(), 'no checkpoint from the pre-stall chunk'

    # rerun with a healthy link: resumes the hole and completes
    coord2 = Coordinator(streamers_total=1, depth=1, analyzers_cpu=1)
    an2 = Analyzer(modelname='hangmodel', model=HangingModel(hang_after=None),
                   dir_audio=str(dir_audio), dir_out=str(dir_out),
                   chunklength=1.0, coordinator=coord2,
                   verbosity_print='CRITICAL', stall_timeout=30.0)
    t2 = threading.Thread(target=an2.run, daemon=True)
    t2.start()
    t2.join(timeout=60)
    assert not t2.is_alive()
    assert coord2.end_reason == 'completed'
    final = dir_out / ('rec' + cfg.SUFFIX_RESULT_COMPLETE)
    assert final.exists() and not partial.exists()
    rows = final.read_text().strip().splitlines()
    assert len(rows) - 1 >= 6, f'resume left holes: {rows}'


def test_execution_target_label_reports_real_backend():
    """The 'processing on ...' line must name where dispatches actually run,
    not a hardcoded 'TPU': with no pin it reports the ambient device; a
    replica-mode device pin reports that device; mesh= reports the mesh.

    Port counterpart: the ambient device is torch's default device (the
    JAX case reads ``jax.default_backend()``), a pin is a ``torch.device``
    (the JAX case pins ``jax.devices()[0]``), and the mesh repeats the CPU
    8 times (the JAX case spans its 8 virtual CPU devices)."""
    import torch

    from buzzdetect_torch.parallel import data_sharding, make_mesh
    from buzzdetect_torch.runtime.inferer import _describe_execution_target

    class Bare:
        pass

    # no pin, no sharding: the ambient device (the CPU in the test env)
    assert _describe_execution_target(Bare()) == 'cpu'
    assert _describe_execution_target(Bare()) == str(
        torch.get_default_device())

    pinned = Bare()
    pinned.device = torch.device('cpu')
    assert _describe_execution_target(pinned) == str(torch.device('cpu'))

    meshed = Bare()
    mesh = make_mesh(devices=['cpu'] * 8, device='cpu')
    meshed.device = None
    meshed.sharding = data_sharding(mesh)
    label = _describe_execution_target(meshed)
    assert label == f'{mesh.devices.size}-device mesh (CPU)', label


def test_execution_target_label_reads_the_built_classifier(tmp_path,
                                                           monkeypatch):
    """The REAL bundle model keeps its placement on model.classifier
    (public device there; private _device on the bundle itself) — the
    label must read the classifier, or replica-mode inferers log the
    ambient backend instead of the real execution target (the stub-only
    test above cannot catch that).

    Port counterpart: the replica pin is ``device='cpu'`` (the JAX case
    pins ``jax.devices()[1]`` of its 8 virtual CPU devices); the mesh
    repeats the CPU 8 times (``make_mesh()`` spans the JAX case's 8
    virtual CPU devices; the port's counts the one CPU)."""
    from buzzdetect_torch import config as cfg
    from buzzdetect_torch.models.convert import build_model_bundle
    from buzzdetect_torch.models.registry import load_model
    from buzzdetect_torch.parallel import make_mesh
    from buzzdetect_torch.runtime.inferer import _describe_execution_target

    dir_models = tmp_path / 'models'
    build_model_bundle(str(dir_models / 'xtm'), classes=['a', 'b'], seed=3)
    monkeypatch.setattr(cfg, 'DIR_MODELS', str(dir_models))

    # replica mode: the pinned device, read off the built classifier
    pinned = load_model('xtm', device='cpu')
    assert not hasattr(pinned, 'classifier') or pinned.classifier is None
    pinned.initialize()
    assert pinned.classifier.device == pinned._device
    assert _describe_execution_target(pinned) == 'cpu'

    # mesh mode: the classifier stores the Mesh itself
    mesh = make_mesh(devices=['cpu'] * 8, device='cpu')
    sharded = load_model('xtm', mesh=mesh, device='cpu')
    sharded.initialize()
    label = _describe_execution_target(sharded)
    assert label == f'{mesh.devices.size}-device mesh (CPU)', label


def test_poison_all_zero_launched_stage_returns_promptly():
    """Interrupted mid-launch: a stage whose workers never started can
    never drain its queue nor signal done, so poisoning it with more
    sentinels than queue capacity spins _poison's put-retry forever —
    e.g. 8 replica analyzers over a 4-slot q_analyze, Ctrl-C during
    queue_assignments. poison_all must take the LAUNCHED counts and skip
    never-started stages."""
    coord = Coordinator(streamers_total=2, analyzers_cpu=8, depth=4)
    assert coord.q_analyze.maxsize < coord.analyzers_total  # the trap
    done = threading.Event()

    def interrupt_path():
        coord.poison_all(streamers=0, analyzers=0, writer=0)
        done.set()

    t = threading.Thread(target=interrupt_path, daemon=True)
    t.start()
    assert done.wait(10), 'poison_all hung on a never-launched stage'
    # never-launched stages get no sentinels (nobody would consume them)
    assert coord.q_analyze.empty() and coord.q_stream.empty()
    assert coord.q_write.empty()


def test_poison_all_wakes_a_blocked_writer():
    """Coordinator.poison_all must be callable outside wait_for_exit: a
    KeyboardInterrupt landing after the workers launch but before
    wait_for_exit starts its watchers has no other poison path, and a
    writer blocked on q_write.get() (no timeout) would never wake."""
    from buzzdetect_torch.runtime.coordination import EXIT
    coord = Coordinator(streamers_total=1, analyzers_cpu=1)
    got = []
    t = threading.Thread(target=lambda: got.append(coord.q_write.get()),
                         daemon=True)
    t.start()
    coord.poison_all()
    t.join(timeout=10)
    assert not t.is_alive() and got == [EXIT]
    # idempotent: a second call must not block or raise
    coord.poison_all()


def test_keyboard_interrupt_before_watchers_drains_the_writer(
        tmp_path, monkeypatch):
    """Ctrl-C in the window after _launch_writer() but before
    wait_for_exit() starts its watcher threads: the writer used to stay
    blocked forever on q_write.get() (nothing poisons the queues outside
    wait_for_exit), burning the full 30 s shutdown join and discarding
    its queued chunks instead of checkpointing them."""
    from buzzdetect_torch import config as cfg
    from buzzdetect_torch.analysis import Analyzer
    from buzzdetect_torch.models.convert import build_model_bundle
    from tests.audio_fixtures import make_tone, write_wav

    root = tmp_path
    build_model_bundle(str(root / 'models' / 'kimodel'),
                       classes=['ins_buzz', 'ambient_noise'], seed=3)
    monkeypatch.setattr(cfg, 'DIR_MODELS', str(root / 'models'))
    dir_audio = root / 'audio'
    dir_audio.mkdir()
    write_wav(dir_audio / 'rec.wav', make_tone(2.0, 16000, 220), 16000)
    dir_out = root / 'out'

    def interrupt(self):
        raise KeyboardInterrupt

    monkeypatch.setattr(Analyzer, '_launch_stall_watchdog', interrupt)
    coord = Coordinator(streamers_total=1, analyzers_cpu=1)
    an = Analyzer(modelname='kimodel', dir_audio=str(dir_audio),
                  dir_out=str(dir_out), chunklength=2.0,
                  coordinator=coord, verbosity_print='CRITICAL',
                  device='cpu')
    t0 = time.monotonic()
    an.run()
    elapsed = time.monotonic() - t0
    assert coord.end_reason == 'interrupted'
    # the writer was woken and joined promptly, not abandoned to the
    # 30 s timeout
    assert elapsed < 25, f'shutdown took {elapsed:.1f}s (writer not woken?)'
    assert an.thread_writer is not None
    an.thread_writer.join(timeout=5)
    assert not an.thread_writer.is_alive()
