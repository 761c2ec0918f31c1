"""tests/test_lock.py, case for case, against ``buzzdetect_torch`` (import
prefix changed, same assertions). Edits: every run is the port's
``analyze()`` on ``device='cpu'`` (the module's ``analyze`` wrapper).

The JAX package's docstring:

Concurrent-run lock: two LIVE runs must never share an output folder.

Interleaved buffered appends from two live writers produce
parseable-but-wrong rows the torn-row guards (built for killed writers)
cannot detect — so the second run refuses up front. The lock is
liveness-checked: SIGKILL debris self-heals, a live owner refuses, a
foreign host (liveness unknowable) refuses with instructions.
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


CLASSES = ['ins_buzz', 'ambient_noise']
DEAD_PID = 2 ** 22 + 12345  # beyond default pid_max; never a live process


@pytest.fixture(scope='module')
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp('lockenv')
    build_model_bundle(str(root / 'models' / 'lockmodel'), classes=CLASSES,
                       seed=5)
    dir_audio = root / 'audio'
    dir_audio.mkdir()
    write_wav(dir_audio / 'tone.wav', make_tone(2.0, 16000, 220), 16000)
    return {'models': str(root / 'models'), 'audio': str(dir_audio)}


@pytest.fixture()
def patched(env, monkeypatch):
    monkeypatch.setattr(cfg, 'DIR_MODELS', env['models'])
    return env


def _kw(patched, dir_out):
    return dict(modelname='lockmodel', dir_audio=patched['audio'],
                dir_out=dir_out, chunklength=2.0, verbosity_print='ERROR')


def _write_lock(dir_out, pid, host, name=None):
    os.makedirs(dir_out, exist_ok=True)
    path = os.path.join(dir_out, name or cfg.FNAME_LOCK)
    with open(path, 'w') as f:
        json.dump({'pid': pid, 'host': host, 'started': 'x'}, f)
    return path


def test_live_lock_refuses_and_preserves_owner_state(patched, tmp_path):
    """A live same-host owner refuses the second run — and the refused
    run must not touch the owner's lock or its summary marker."""
    import socket
    dir_out = str(tmp_path / 'out')
    path = _write_lock(dir_out, os.getpid(), socket.gethostname())
    before = open(path).read()

    a = analyze(**_kw(patched, dir_out))
    assert a.coordinator.end_reason == 'already running'
    assert open(path).read() == before, 'refused run modified the lock'
    assert not os.path.exists(os.path.join(dir_out, cfg.FNAME_RUN_SUMMARY)), \
        'refused run clobbered the live owner\'s summary'
    assert not os.path.exists(
        os.path.join(dir_out, 'tone_buzzdetect.csv'))


def test_stale_same_host_lock_self_heals(patched, tmp_path):
    """SIGKILL debris: same host, dead pid — reclaim and run."""
    import socket
    dir_out = str(tmp_path / 'out')
    _write_lock(dir_out, DEAD_PID, socket.gethostname())
    a = analyze(**_kw(patched, dir_out))
    assert a.coordinator.end_reason == 'completed'
    assert not os.path.exists(os.path.join(dir_out, cfg.FNAME_LOCK)), \
        'lock not released after completion'


def test_corrupt_lock_is_stale(patched, tmp_path):
    """A crash between O_EXCL and the json dump leaves garbage: stale."""
    dir_out = str(tmp_path / 'out')
    os.makedirs(dir_out)
    with open(os.path.join(dir_out, cfg.FNAME_LOCK), 'w') as f:
        f.write('\x00garbage')
    a = analyze(**_kw(patched, dir_out))
    assert a.coordinator.end_reason == 'completed'


def test_foreign_host_lock_refuses(patched, tmp_path):
    """Another machine's lock can't be liveness-checked — refuse with the
    owner's identity and manual instructions, even if ITS pid happens to
    be dead here."""
    dir_out = str(tmp_path / 'out')
    _write_lock(dir_out, DEAD_PID, 'some-other-fieldbox')
    a = analyze(**_kw(patched, dir_out))
    assert a.coordinator.end_reason == 'already running'


def test_host_shard_locks_are_disjoint(patched, tmp_path):
    """Hosts legitimately share dir_out: host 0's (live) lock must not
    block host 1's shard."""
    import socket
    dir_out = str(tmp_path / 'out')
    _write_lock(dir_out, os.getpid(), socket.gethostname(),
                name=cfg.FNAME_LOCK + '_host0')
    a = analyze(host_shard=(1, 2), **_kw(patched, dir_out))
    assert a.coordinator.end_reason in ('completed', 'fully analyzed')
    assert not os.path.exists(
        os.path.join(dir_out, cfg.FNAME_LOCK + '_host1'))
    # and a second host-1 run against a live host-1 lock refuses
    _write_lock(dir_out, os.getpid(), socket.gethostname(),
                name=cfg.FNAME_LOCK + '_host1')
    a = analyze(host_shard=(1, 2), **_kw(patched, dir_out))
    assert a.coordinator.end_reason == 'already running'


def test_lock_released_on_crash(patched, tmp_path, monkeypatch):
    """The finally releases the lock even when the run loop raises — an
    in-process crash must not wedge the folder until manual cleanup."""
    from buzzdetect_torch import analysis as analysis_mod
    dir_out = str(tmp_path / 'out')

    def boom(self):
        raise RuntimeError('upload failed')
    monkeypatch.setattr(analysis_mod.Analyzer, '_launch_writer', boom)
    with pytest.raises(RuntimeError):
        analyze(**_kw(patched, dir_out))
    assert not os.path.exists(os.path.join(dir_out, cfg.FNAME_LOCK))


def test_watch_cycles_reacquire_cleanly(patched, tmp_path):
    """The session claim spans all watch cycles; nothing left behind."""
    dir_out = str(tmp_path / 'out')
    analyze(watch=True, watch_interval=0.0, watch_cycles=3,
            **_kw(patched, dir_out))
    assert not os.path.exists(os.path.join(dir_out, cfg.FNAME_LOCK))


def test_watch_session_lock_spans_idle_intervals(patched, tmp_path):
    """A watch session holds the dir_out claim BETWEEN passes.

    With per-pass locking, a second run arriving during the watcher's
    (long) idle interval found no lock and proceeded — two live runs
    alternating ownership of the same folder, each demoting and
    re-finalizing the other's work. The claim must now be session-scoped:
    held through the idle interval, refusing both a one-shot run and a
    second watcher at their FIRST pass, and released only when the watch
    loop ends."""
    import json
    import threading
    import time

    dir_out = str(tmp_path / 'out')
    path_lock = os.path.join(dir_out, cfg.FNAME_LOCK)
    stop = threading.Event()

    def watcher():
        analyze(watch=True, watch_interval=60.0, watch_stop=stop,
                **_kw(patched, dir_out))

    t = threading.Thread(target=watcher, daemon=True)
    t.start()
    try:
        # wait for pass 1 to finish (finalized result present) — the
        # watcher is then parked in its 60 s stop.wait
        done = os.path.join(dir_out, 'tone_buzzdetect.csv')
        deadline = time.monotonic() + 120
        while not os.path.exists(done):
            assert time.monotonic() < deadline, 'watch pass never finished'
            assert t.is_alive(), 'watcher died before finishing a pass'
            time.sleep(0.02)
        # give the pass's end path a moment, then: the lock must STILL be
        # held even though no pass is running
        time.sleep(0.2)
        assert os.path.exists(path_lock), \
            'watch session released the lock between passes'
        with open(path_lock) as f:
            assert json.load(f)['pid'] == os.getpid()

        # a one-shot run into the watched folder refuses immediately
        a = analyze(**_kw(patched, dir_out))
        assert a.coordinator.end_reason == 'already running'

        # a SECOND watcher refuses at its first pass and its loop ends —
        # it must not retry forever or claim the folder
        b = analyze(watch=True, watch_interval=0.01, watch_cycles=50,
                    **_kw(patched, dir_out))
        assert b.coordinator.end_reason == 'already running'
        assert os.path.exists(path_lock), \
            'refused watcher removed the live owner\'s lock'
    finally:
        stop.set()
    t.join(timeout=60)
    assert not t.is_alive(), 'watcher did not stop'
    assert not os.path.exists(path_lock), \
        'watch session left its lock behind after stopping'


def test_session_lock_same_process_sibling_not_adopted(tmp_path):
    """Ownership is the per-acquisition claim token, not (pid, host).

    Two runs in one process share the pid (analyze() is a library API and
    the suite itself runs watchers as threads), so after an operator
    hand-deletes a watcher's lock and a same-process sibling run claims
    the folder, a pid/host check would read the sibling's lock as 'ours':
    the watcher's next pass would proceed — two live runs in one folder —
    and its release would unlink the sibling's LIVE lock, opening the
    folder to a third."""
    from buzzdetect_torch.analysis import SessionLock
    dir_out = str(tmp_path / 'out')
    a = _stub_acquirer(dir_out)
    lock = SessionLock()
    assert lock.ensure(a) is True
    path = os.path.join(dir_out, cfg.FNAME_LOCK)

    os.unlink(path)              # operator escape hatch fires mid-session
    b = _stub_acquirer(dir_out)  # sibling run, SAME pid, claims the folder
    assert b._acquire_lock() is True
    sibling = open(path).read()

    # the watcher's next pass must refuse, not adopt the sibling's lock
    assert lock.ensure(a) is False
    assert a.refusals == ['already running']
    assert open(path).read() == sibling

    # releasing the lost session claim must not remove the sibling's lock
    lock.release()
    assert open(path).read() == sibling
    # and the sibling's own release removes exactly its claim
    b._release_lock()
    assert not os.path.exists(path)


def test_session_lock_reclaims_hand_deleted_file(tmp_path):
    """The documented operator escape hatch ('delete <lock> and rerun')
    can fire mid-session: each pass re-verifies ownership, so a vanished
    lock file is re-claimed rather than silently assumed held — and a
    foreign LIVE lock that replaced it refuses the pass instead of being
    clobbered."""
    from buzzdetect_torch.analysis import SessionLock
    dir_out = str(tmp_path / 'out')
    lock = SessionLock()
    a = _stub_acquirer(dir_out)
    assert lock.ensure(a) is True
    path = os.path.join(dir_out, cfg.FNAME_LOCK)
    assert os.path.exists(path)
    # pass 2 with the claim intact: no re-acquisition churn, still held
    assert lock.ensure(a) is True

    # operator deletes the lock mid-session: the next pass re-claims
    os.unlink(path)
    assert lock.ensure(a) is True
    assert os.path.exists(path), 'vanished lock was not re-claimed'

    # a live foreign owner replaced our lock: the pass must refuse and
    # leave the foreign lock untouched
    os.unlink(path)
    _write_lock(dir_out, os.getpid() + 1, 'some-other-fieldbox')
    foreign = open(path).read()
    b = _stub_acquirer(dir_out)
    b_lock = SessionLock()
    # (use a fresh stub whose refusals list we inspect)
    assert b_lock.ensure(b) is False
    assert b.refusals == ['already running']
    assert open(path).read() == foreign
    lock.release()  # releasing a lost claim must not remove the foreign lock
    assert os.path.exists(path)


def _stub_acquirer(dir_out):
    """A minimal object exposing exactly what _acquire_lock needs — the
    full Analyzer constructor loads a model, which these concurrency
    tests neither need nor want."""
    import types
    from buzzdetect_torch.analysis import Analyzer
    from buzzdetect_torch.utils import Timer
    a = Analyzer.__new__(Analyzer)
    a.dir_out = dir_out
    a.host_shard = None
    a.timer_total = Timer()
    a.refusals = []
    a.coordinator = types.SimpleNamespace(
        exit_analysis=lambda sig: a.refusals.append(sig.end_reason))
    return a


def test_lock_name_never_appears_without_content(tmp_path):
    """The claim must publish the lock atomically WITH its json — a
    create-then-write claim has an empty-file window a racer reads as
    'corrupt stale' and deletes, letting two live runs share the dir."""
    dir_out = str(tmp_path / 'out')
    a = _stub_acquirer(dir_out)
    assert a._acquire_lock() is True
    path = os.path.join(dir_out, cfg.FNAME_LOCK)
    with open(path) as f:
        owner = json.load(f)  # parseable immediately after the claim
    assert owner['pid'] == os.getpid()
    # and the claim leaves no temp debris behind
    leftovers = [n for n in os.listdir(dir_out) if n != cfg.FNAME_LOCK]
    assert leftovers == [], leftovers
    a._release_lock()
    assert not os.path.exists(path)


def test_stale_reclaim_survives_flock_refusal(tmp_path, monkeypatch):
    """dir_out on a filesystem that refuses directory flocks (NFS mounted
    nolock: ENOLCK): the reclaim must fall back to the documented
    unserialized blind unlink, not crash lock acquisition — the OSError
    used to propagate out of _acquire_lock, killing the run a stale lock
    should have self-healed."""
    import fcntl
    import socket

    def no_flock(fd, op):
        raise OSError(37, 'No locks available')

    monkeypatch.setattr(fcntl, 'flock', no_flock)
    dir_out = str(tmp_path / 'out')
    os.makedirs(dir_out)
    _write_lock(dir_out, DEAD_PID, socket.gethostname())
    a = _stub_acquirer(dir_out)
    assert a._acquire_lock() is True, a.refusals
    a._release_lock()


def test_stale_reclaim_is_single_winner_under_contention(tmp_path):
    """N racers observing the same stale lock: exactly ONE may win the
    reclaim. The unserialized judge-then-unlink sequence let a second
    racer unlink the first racer's FRESH lock (both saw the same dead
    owner before either claimed) — the exact two-live-runs corruption
    the lock exists to prevent."""
    import socket
    import threading
    host = socket.gethostname()
    for _ in range(10):
        dir_out = str(tmp_path / 'out')
        os.makedirs(dir_out, exist_ok=True)
        _write_lock(dir_out, DEAD_PID, host)
        acquirers = [_stub_acquirer(dir_out) for _ in range(8)]
        barrier = threading.Barrier(len(acquirers))
        results = [None] * len(acquirers)

        def race(i):
            barrier.wait()
            results[i] = acquirers[i]._acquire_lock()

        threads = [threading.Thread(target=race, args=(i,))
                   for i in range(len(acquirers))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert sum(results) == 1, results
        # the surviving lock belongs to the winner, not the dead pid
        with open(os.path.join(dir_out, cfg.FNAME_LOCK)) as f:
            assert json.load(f)['pid'] == os.getpid()
        import shutil
        shutil.rmtree(dir_out)
