"""The port's layouts that need no collective, on the CPU:
per-device replicas (``analyze(devices=...)``) and the multi-host file
shard (``analyze(host_shard=...)``, ``--host_shard``), against the JAX
package's ``shard_files`` and against one-device, one-host runs.

Mirrors tests/test_parallel.py's replica and host-shard tests with
``device='cpu'``: two replicas on the one CPU stand in for two on one card.
"""

import os
import subprocess
import sys

import pytest
import torch

from buzzdetect_tpu.models.convert import build_model_bundle
from buzzdetect_tpu.parallel import shard_files as jax_shard_files
from buzzdetect_torch import config as tcfg
from buzzdetect_torch.analysis import Analyzer, analyze
from buzzdetect_torch.parallel import (make_mesh, process_rank,
                                       resolve_replica_devices, shard_files)
from tests.audio_fixtures import make_tone, write_wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device('cpu')


# --- shard_files --------------------------------------------------------------

def test_shard_files_partition_matches_jax():
    """Complete and disjoint, stable under reordering, everything for one
    host, and the same owner for every file as the JAX package's."""
    paths = [f'audio/file{i:04d}.wav' for i in range(200)]
    shards = [shard_files(paths, host_id=h, n_hosts=4) for h in range(4)]
    assert sorted(p for s in shards for p in s) == sorted(paths)
    assert sum(map(len, shards)) == len(paths)
    reordered = shard_files(list(reversed(paths)), host_id=2, n_hosts=4)
    assert sorted(reordered) == sorted(shards[2])
    assert shard_files(paths, host_id=0, n_hosts=1) == paths
    for h in range(4):
        assert shards[h] == jax_shard_files(paths, host_id=h, n_hosts=4)
    print('shard sizes over 200 files, 4 hosts: '
          + ', '.join(str(len(s)) for s in shards))


def test_shard_files_root_relative_agreement():
    """Hosts that mount the corpus at different absolute paths agree on
    every file's owner, as the JAX package's hosts do."""
    rel = [f'site{i}/rec{j}.wav' for i in range(3) for j in range(5)]
    a = [f'/data/audio/{r}' for r in rel]
    b = [f'/mnt/shared/audio/{r}' for r in rel]
    for host in range(4):
        mine_a = shard_files(a, host_id=host, n_hosts=4, root='/data/audio')
        mine_b = shard_files(b, host_id=host, n_hosts=4,
                             root='/mnt/shared/audio')
        assert ([p[len('/data/audio/'):] for p in mine_a]
                == [p[len('/mnt/shared/audio/'):] for p in mine_b])
        assert mine_a == jax_shard_files(a, host_id=host, n_hosts=4,
                                         root='/data/audio')


def test_shard_defaults_come_from_torch_distributed(monkeypatch):
    """Without a process group this process is host 0 of 1 (what JAX
    answers in one process); with one, its rank and world size."""
    import torch.distributed as dist
    paths = [f'r{i}.wav' for i in range(40)]
    assert process_rank() == (0, 1)
    assert shard_files(paths) == paths
    monkeypatch.setattr(dist, 'is_initialized', lambda: True)
    monkeypatch.setattr(dist, 'get_rank', lambda: 1)
    monkeypatch.setattr(dist, 'get_world_size', lambda: 3)
    assert process_rank() == (1, 3)
    assert shard_files(paths) == shard_files(paths, host_id=1, n_hosts=3)
    assert shard_files(paths, host_id=2) == shard_files(paths, 2, 3)


# --- resolve_replica_devices ------------------------------------------------------

def test_resolve_replica_devices():
    """An int or 'all' counts the devices of ``device``'s type (one CPU
    here); an explicit list may repeat a device; nothing silently shrinks
    the fleet."""
    assert resolve_replica_devices(1, 'cpu') == [CPU]
    assert resolve_replica_devices('all', 'cpu') == [CPU]
    assert resolve_replica_devices(['cpu', 'cpu'], 'cpu') == [CPU, CPU]
    assert resolve_replica_devices([CPU], 'cuda') == [CPU]
    assert resolve_replica_devices(('cpu',)) == [CPU]
    with pytest.raises(ValueError):
        resolve_replica_devices(0, 'cpu')
    with pytest.raises(ValueError, match='only 1 local cpu device'):
        resolve_replica_devices(2, 'cpu')   # never silently shrink
    with pytest.raises(ValueError, match='empty'):
        resolve_replica_devices([], 'cpu')


def test_resolve_replica_devices_refusals():
    """Stray strings, booleans, devices that are not attached and device
    types the port does not run on."""
    assert torch.cuda.device_count() == 0   # tests/conftest.py hides it
    for bad in ('4', True, None):
        with pytest.raises(ValueError, match="int >= 1, 'all'"):
            resolve_replica_devices(bad, 'cpu')
    with pytest.raises(ValueError, match='only 0 local cuda'):
        resolve_replica_devices(1)
    with pytest.raises(ValueError, match='no cuda device is attached'):
        resolve_replica_devices('all')
    with pytest.raises(ValueError, match='only 0 CUDA device'):
        resolve_replica_devices(['cuda:0'])
    with pytest.raises(ValueError, match='not a device'):
        resolve_replica_devices(['gpu7'])
    with pytest.raises(ValueError, match="CUDA devices or 'cpu'"):
        resolve_replica_devices(['meta'])
    with pytest.raises(ValueError, match='device must be'):
        resolve_replica_devices(1, 'meta')


# --- analyze(host_shard=...) validation -------------------------------------------

def test_host_shard_validation():
    """The JAX package's argument check, messages included, before any
    other setup."""
    model = object.__new__(object)
    with pytest.raises(ValueError, match='host_shard'):
        Analyzer(modelname='whatever', host_shard=(4, 2), model=model)
    for bad in (1, '0/4', (0,), (0, 2, 4), (0.0, 2), (True, 2), (-1, 2)):
        with pytest.raises(ValueError, match='host_shard must be'):
            Analyzer(modelname='whatever', host_shard=bad, model=model)


# --- end to end on the CPU --------------------------------------------------------

@pytest.fixture
def corpus(tmp_path, monkeypatch):
    """A seeded bundle 'rm' in a models folder the port reads, and a folder
    of short 16 kHz tones."""
    def make(n_files=4, rate=16000, seconds=2.5):
        dir_models = tmp_path / 'models'
        if not (dir_models / 'rm').exists():
            build_model_bundle(str(dir_models / 'rm'),
                               classes=['a', 'ins_buzz'], seed=11)
        monkeypatch.setattr(tcfg, 'DIR_MODELS', str(dir_models))
        dir_audio = tmp_path / f'audio_{rate}'
        dir_audio.mkdir()
        for i in range(n_files):
            write_wav(dir_audio / f'r{i}.wav',
                      make_tone(seconds + 0.5 * i, rate, 200 + 60 * i), rate)
        return str(dir_audio)
    return make


def _run(dir_audio, dir_out, **kw):
    a = analyze(modelname='rm', dir_audio=dir_audio, dir_out=str(dir_out),
                chunklength=2.0, verbosity_print='ERROR', device='cpu', **kw)
    assert a.coordinator.end_reason == 'completed'
    return a


def _same_csvs(got_dir, want_dir, n_files):
    for i in range(n_files):
        got = open(os.path.join(got_dir, f'r{i}_buzzdetect.csv')).read()
        want = open(os.path.join(want_dir, f'r{i}_buzzdetect.csv')).read()
        assert got == want, f'r{i}: CSVs differ'


def test_replica_devices_match_one_device(corpus, tmp_path):
    """devices=['cpu', 'cpu']: two replicas, each its own model on the CPU
    with its own dispatch thread; CSVs byte-identical to one device."""
    dir_audio = corpus(n_files=5)
    _run(dir_audio, tmp_path / 'single')
    a = _run(dir_audio, tmp_path / 'replicas', devices=['cpu', 'cpu'],
             n_streamers=2)
    assert a.coordinator.analyzers_total == 2
    assert len(a.replica_models) == 2
    assert len({id(m) for m in a.replica_models}) == 2
    for m in a.replica_models:
        assert m.device == CPU
        assert m.classifier is not None   # each replica served
    _same_csvs(tmp_path / 'replicas', tmp_path / 'single', 5)


def test_multiple_dispatch_threads_per_replica(corpus, tmp_path):
    """In replica mode analyzers_cpu counts dispatch threads PER replica:
    2 replicas x 2 threads share 2 models, grouped by replica; CSVs still
    byte-identical."""
    dir_audio = corpus(n_files=4)
    _run(dir_audio, tmp_path / 'single')
    a = _run(dir_audio, tmp_path / 'multi', devices=['cpu', 'cpu'],
             analyzers_cpu=2)
    assert a.coordinator.analyzers_total == 4
    assert len(a.replica_models) == 4
    ids = [id(m) for m in a.replica_models]
    assert len(set(ids)) == 2 and ids[0] == ids[1] and ids[2] == ids[3]
    _same_csvs(tmp_path / 'multi', tmp_path / 'single', 4)


def test_host_shard_composes_with_replica_devices(corpus, tmp_path):
    """Each of two hosts analyzes its shard with two replicas; together
    they equal the one-host, one-device run."""
    dir_audio = corpus(n_files=4)
    dir_out = tmp_path / 'out'
    done = []
    for host in range(2):
        a = analyze(modelname='rm', dir_audio=dir_audio, dir_out=str(dir_out),
                    chunklength=2.0, verbosity_print='ERROR', device='cpu',
                    host_shard=(host, 2), devices=['cpu', 'cpu'],
                    n_streamers=1)
        assert a.coordinator.analyzers_total == 2
        assert a.host_shard == (host, 2)
        done.append(a.coordinator.end_reason)
    assert 'completed' in done
    _run(dir_audio, tmp_path / 'oracle')
    _same_csvs(dir_out, tmp_path / 'oracle', 4)


def test_replicas_compose_with_mulaw_and_device_resample(corpus, tmp_path):
    """Replicas x mu-law wire x on-device resampling of 48 kHz sources
    equals the one-device run with the same wire configuration."""
    dir_audio = corpus(n_files=2, rate=48000, seconds=3.0)
    kw = dict(transfer_dtype='mulaw', resample_on_device=True)
    _run(dir_audio, tmp_path / 'single', **kw)
    _run(dir_audio, tmp_path / 'replicas', devices=['cpu', 'cpu'], **kw)
    _same_csvs(tmp_path / 'replicas', tmp_path / 'single', 2)


def test_devices_and_mesh_are_mutually_exclusive(corpus, tmp_path):
    """Both layouts at once is a ValueError before any model loads, at
    analyze() and at the Analyzer alike."""
    dir_audio = corpus(n_files=1)
    mesh = make_mesh(devices=['cpu'] * 4, device='cpu')
    with pytest.raises(ValueError, match='mutually exclusive'):
        analyze(modelname='rm', dir_audio=dir_audio, device='cpu',
                dir_out=str(tmp_path / 'out'), devices=1, mesh=mesh)
    with pytest.raises(ValueError, match='mutually exclusive'):
        Analyzer(modelname='rm', dir_audio=dir_audio, device='cpu',
                 devices=1, mesh=mesh)
    assert not (tmp_path / 'out').exists()


def test_replica_mode_needs_whole_threads_per_device(corpus):
    """An Analyzer handed a coordinator whose analyzer count does not split
    evenly over the replicas refuses, naming analyze(devices=...)."""
    from buzzdetect_torch.runtime.coordination import Coordinator
    dir_audio = corpus(n_files=1)
    with pytest.raises(ValueError, match='whole number of dispatch'):
        Analyzer(modelname='rm', dir_audio=dir_audio, device='cpu',
                 devices=['cpu', 'cpu'],
                 coordinator=Coordinator(analyzers_cpu=3))


# children of the concurrent-hosts test: one thread each for torch's and
# the BLAS pools, so two children and the oracle do not oversubscribe a
# loaded machine
CHILD_ENV = {'OMP_NUM_THREADS': '1', 'MKL_NUM_THREADS': '1',
             'OPENBLAS_NUM_THREADS': '1'}
CHILD_TIMEOUT = 240


def test_cli_host_shard_concurrent_hosts(corpus, tmp_path):
    """Two CONCURRENT hosts (``python -m buzzdetect_torch --host_shard I/2
    --device cpu`` processes), one shared output folder, no coordination:
    together they complete every file, byte-identical to a one-host run;
    rerunning a host over the finished folder touches nothing."""
    dir_audio = corpus(n_files=6, seconds=2.0)
    dir_out = str(tmp_path / 'shared_out')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env.update(CHILD_ENV, BUZZDETECT_DIR_MODELS=tcfg.DIR_MODELS)

    def host(i):
        return subprocess.Popen(
            [sys.executable, '-m', 'buzzdetect_torch', '--modelname', 'rm',
             '--dir_audio', dir_audio, '--dir_out', dir_out,
             '--chunklength', '2', '--verbosity_print', 'ERROR',
             '--device', 'cpu', '--host_shard', f'{i}/2'],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)

    procs = [host(i) for i in range(2)]
    children = []   # each child's exit code and the tail of its stderr
    try:
        for i, p in enumerate(procs):
            _out, err = p.communicate(timeout=CHILD_TIMEOUT)
            children.append(f'host {i}: exit {p.returncode}, stderr '
                            f'{err.decode()[-2000:]!r}')
            assert p.returncode == 0, children[-1]
    finally:
        for p in procs:
            p.kill()
    _run(dir_audio, tmp_path / 'oracle')
    for i in range(6):
        got = open(os.path.join(dir_out, f'r{i}_buzzdetect.csv')).read()
        want = open(tmp_path / 'oracle' / f'r{i}_buzzdetect.csv').read()
        assert got == want, f'r{i}: CSVs differ; {"; ".join(children)}'
    assert [f for f in os.listdir(dir_out)
            if f.endswith('_buzzpart.csv')] == [], '; '.join(children)
    mine = [shard_files(sorted(os.listdir(dir_audio)), h, 2) for h in (0, 1)]
    print(f'host 0 analyzed {mine[0]}, host 1 {mine[1]}')

    before = {f: os.path.getmtime(os.path.join(dir_out, f))
              for f in os.listdir(dir_out) if f.endswith('.csv')}
    p = host(0)
    try:
        _out, err = p.communicate(timeout=CHILD_TIMEOUT)
    finally:
        p.kill()
    rerun = (f'host 0 rerun: exit {p.returncode}, stderr '
             f'{err.decode()[-2000:]!r}')
    assert p.returncode == 0, rerun
    after = {f: os.path.getmtime(os.path.join(dir_out, f))
             for f in os.listdir(dir_out) if f.endswith('.csv')}
    assert before == after, rerun
