"""tests/test_parallel.py, case for case, against ``buzzdetect_torch``
(import prefix changed, same assertions, every run on the CPU;
``test_torch_mesh.py`` and ``test_torch_parallel.py`` hold the port's own
cases, which compare with the JAX package step for step). Edits:

* the JAX cases count 8 virtual CPU devices (tests/conftest.py); the port
  counts the one CPU, so its meshes and replica lists repeat it
  (``['cpu'] * 8``, ``devices=['cpu'] * 4``), as on one card they repeat
  ``'cuda:0'``, and ``make_mesh(8)`` / ``devices=N`` past one CPU raise;
* a mesh is no ambient context in the port (no ``with mesh:``): it goes to
  ``train_head``, ``make_full_train_step`` and ``train_full_model`` as an
  argument, as the JAX calls pass it too;
* the full train step is the port's ``make_full_train_step(optimizer,
  params, mesh=)``, whose ``step(waveforms, labels)`` steps the optimizer
  in place (the JAX step returns new params and state);
* a mesh resolves conv to the XLA conv path, as the JAX package's does, so
  the unsharded run the meshed CSV must equal byte for byte is the same
  bundle with ``"conv": "xla"`` in its config (the JAX case's CPU default
  is that path too);
* a replica's parameters are checked on its device through its
  classifier's tensors (the JAX case reads a jax array's ``devices()``);
* the two host processes run ``python -m buzzdetect_torch --host_shard``
  with ``--device cpu`` (the JAX case runs ``analyze(host_shard=)`` in
  ``python -c``), and their assertions carry each child's exit code and
  the tail of its stderr.

The JAX package's docstring:

Multi-chip parallelism tests on the virtual 8-device CPU mesh: sharded
inference equals single-device inference; file sharding is a stable
partition; head/full training steps compile and run over DP and DPxTP meshes.
"""

import json
import shutil

import numpy as np
import pytest
import torch

from buzzdetect_torch.parallel import make_mesh, shard_files
from buzzdetect_torch.models import classifier as clf_mod
from buzzdetect_torch.models import yamnet as yam
from buzzdetect_torch.models.heads import init_head

RNG = np.random.default_rng(0)
CPU = torch.device('cpu')
CPU8 = ['cpu'] * 8
# the host processes' threads and time limit (the test run shares the
# machine's cores among its workers)
CHILD_ENV = {'OMP_NUM_THREADS': '1', 'MKL_NUM_THREADS': '1'}
CHILD_TIMEOUT = 600


def ChunkClassifier(arrays, **kw):
    """The port's ChunkClassifier, on the CPU."""
    kw.setdefault('device', 'cpu')
    return clf_mod.ChunkClassifier(arrays, **kw)


def analyze(**kw):
    """The port's analyze(), on the CPU."""
    from buzzdetect_torch import analysis
    kw.setdefault('device', 'cpu')
    return analysis.analyze(**kw)


def _mesh_2d(data, model):
    return make_mesh(devices=['cpu'] * (data * model), shape=(data, model),
                     axes=('data', 'model'), device='cpu')


@pytest.fixture(scope='module')
def arrays():
    raw = yam.init_raw_params(seed=4)
    folded = yam.fold_batchnorm(raw)
    a = {f'yamnet/{k}': v for k, v in folded.items()}
    a.update(init_head(1024, 5, seed=4))
    return a


def test_mesh_construction():
    mesh = make_mesh(devices=CPU8, device='cpu')
    assert mesh.devices.shape == (8,)
    assert mesh.axis_names == ('data',)


def test_sharded_inference_matches_single(arrays):
    wav = (RNG.standard_normal(int(9.6 * 16000)) * 0.1).astype(np.float32)

    single = ChunkClassifier(arrays, framehop_prop=1.0).predict(wav)

    mesh = make_mesh(devices=CPU8, device='cpu')
    sharded = ChunkClassifier(arrays, framehop_prop=1.0,
                              mesh=mesh).predict(wav)
    assert sharded.shape == single.shape
    np.testing.assert_allclose(sharded, single, atol=1e-4)


def test_sharded_inference_uneven_patches(arrays):
    # 7 patches over 8 devices: the split must handle the ragged shard
    wav = (RNG.standard_normal(int(6.7 * 16000)) * 0.1).astype(np.float32)
    mesh = make_mesh(devices=CPU8, device='cpu')
    single = ChunkClassifier(arrays, framehop_prop=1.0).predict(wav)
    sharded = ChunkClassifier(arrays, framehop_prop=1.0,
                              mesh=mesh).predict(wav)
    np.testing.assert_allclose(sharded, single, atol=1e-4)


def test_shard_files_partition():
    paths = [f'audio/file{i:04d}.wav' for i in range(200)]
    shards = [shard_files(paths, host_id=h, n_hosts=4) for h in range(4)]
    # complete and disjoint
    union = sorted(p for s in shards for p in s)
    assert union == sorted(paths)
    # stable regardless of listing order
    reordered = shard_files(list(reversed(paths)), host_id=2, n_hosts=4)
    assert sorted(reordered) == sorted(shards[2])
    # single host gets everything
    assert shard_files(paths, host_id=0, n_hosts=1) == paths


def test_head_train_step_dp_tp():
    from buzzdetect_torch.train.trainer import train_head
    mesh = _mesh_2d(4, 2)
    emb = RNG.standard_normal((64, 1024)).astype(np.float32)
    labels = (RNG.random((64, 3)) > 0.7).astype(np.float32)
    params, losses = train_head(emb, labels, epochs=3, batch_size=32,
                                mesh=mesh, device='cpu')
    assert params['head/kernel'].shape == (1024, 3)
    # loss must decrease
    assert losses[-1] < losses[0]


def test_head_training_learns_separable_data():
    from buzzdetect_torch.train.trainer import train_head
    # embeddings where class 0 is linearly separable on one dimension
    n = 256
    emb = RNG.standard_normal((n, 1024)).astype(np.float32)
    labels = np.zeros((n, 2), np.float32)
    labels[:, 0] = (emb[:, 7] > 0).astype(np.float32)
    labels[:, 1] = (emb[:, 11] > 0).astype(np.float32)
    params, losses = train_head(emb, labels, epochs=30, batch_size=64,
                                learning_rate=0.01, device='cpu')
    logits = emb @ params['head/kernel'] + params['head/bias']
    acc = ((logits[:, 0] > 0) == (labels[:, 0] > 0.5)).mean()
    assert acc > 0.9


def test_full_train_step_runs_and_learns():
    from buzzdetect_torch.train.trainer import (make_full_train_step,
                                                init_full_train)
    mesh = _mesh_2d(4, 2)
    params, optimizer = init_full_train(n_classes=3, learning_rate=1e-3,
                                        device='cpu')
    step = make_full_train_step(optimizer, params, mesh=mesh)
    wav = torch.from_numpy(
        (RNG.standard_normal((4, 15600)) * 0.1).astype(np.float32))
    labels = np.zeros((4, 3), np.float32)
    labels[:2, 0] = 1
    losses = []
    for _ in range(5):
        loss = step(wav, torch.from_numpy(labels))
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def _bundle_pair(dir_models, name, seed):
    """``name`` and ``name``_xla: the same seeded bundle, the second's
    config saying ``"conv": "xla"``."""
    from buzzdetect_torch.models.convert import build_model_bundle
    build_model_bundle(str(dir_models / name), classes=['a', 'ins_buzz'],
                       seed=seed)
    shutil.copytree(dir_models / name, dir_models / f'{name}_xla')
    path = dir_models / f'{name}_xla' / 'config_model.json'
    path.write_text(json.dumps({**json.loads(path.read_text()),
                                'conv': 'xla'}))


def test_analyze_with_mesh(tmp_path, monkeypatch):
    """Top-level multi-device inference: analyze(mesh=...) splits each
    chunk's patch axis across 8 devices; results match the unsharded run
    on the same (XLA) conv path byte for byte."""
    from buzzdetect_torch import config as cfg
    from tests.audio_fixtures import make_tone, write_wav

    dir_models = tmp_path / 'models'
    _bundle_pair(dir_models, 'pm', seed=9)
    monkeypatch.setattr(cfg, 'DIR_MODELS', str(dir_models))
    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    write_wav(dir_audio / 't.wav', make_tone(4.0, 16000), 16000)

    analyze(modelname='pm_xla', dir_audio=str(dir_audio),
            dir_out=str(tmp_path / 'single'), chunklength=4.0,
            verbosity_print='ERROR')
    analyze(modelname='pm', dir_audio=str(dir_audio),
            dir_out=str(tmp_path / 'meshed'), chunklength=4.0,
            verbosity_print='ERROR',
            mesh=make_mesh(devices=CPU8, device='cpu'))

    a = open(tmp_path / 'single' / 't_buzzdetect.csv').read()
    b = open(tmp_path / 'meshed' / 't_buzzdetect.csv').read()
    assert a == b


def test_shard_files_root_relative_agreement():
    """Hosts mounting the corpus at different absolute paths must agree on
    every file's owner — the hash covers the root-relative path."""
    rel = [f'site{i}/rec{j}.wav' for i in range(3) for j in range(5)]
    a = [f'/data/audio/{r}' for r in rel]
    b = [f'/mnt/shared/audio/{r}' for r in rel]
    for host in range(4):
        mine_a = shard_files(a, host_id=host, n_hosts=4, root='/data/audio')
        mine_b = shard_files(b, host_id=host, n_hosts=4,
                             root='/mnt/shared/audio')
        assert ([p[len('/data/audio/'):] for p in mine_a]
                == [p[len('/mnt/shared/audio/'):] for p in mine_b])


def test_make_mesh_2d_for_trainer():
    """make_mesh must be able to build the DPxTP ('data','model') mesh the
    trainer's sharding requires."""
    n = len(CPU8)
    if n < 4:
        pytest.skip('needs >= 4 devices')
    mesh = make_mesh(devices=CPU8, shape=(n // 2, 2),
                     axes=('data', 'model'), device='cpu')
    assert mesh.axis_names == ('data', 'model')
    assert mesh.devices.shape == (n // 2, 2)


# --- per-device replica data parallelism (analyze(devices=...)) --------------

def _replica_env(tmp_path, monkeypatch, n_files=5):
    from buzzdetect_torch import config as cfg
    from buzzdetect_torch.models.convert import build_model_bundle
    from tests.audio_fixtures import make_tone, write_wav
    dir_models = tmp_path / 'models'
    build_model_bundle(str(dir_models / 'rm'), classes=['a', 'ins_buzz'],
                       seed=11)
    monkeypatch.setattr(cfg, 'DIR_MODELS', str(dir_models))
    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    for i in range(n_files):
        write_wav(dir_audio / f'r{i}.wav',
                  make_tone(3.0 + i, 16000, 200 + 60 * i), 16000)
    return str(dir_audio)


def test_resolve_replica_devices():
    from buzzdetect_torch.parallel import resolve_replica_devices
    local = [CPU]
    assert resolve_replica_devices(1, 'cpu') == local[:1]
    assert resolve_replica_devices('all', 'cpu') == local
    assert resolve_replica_devices([local[0]], 'cpu') == [local[0]]
    with pytest.raises(ValueError):
        resolve_replica_devices(0, 'cpu')
    with pytest.raises(ValueError):
        resolve_replica_devices(len(local) + 1, 'cpu')  # never shrink
    with pytest.raises(ValueError):
        resolve_replica_devices([], 'cpu')


def test_analyze_with_replica_devices_matches_single(tmp_path, monkeypatch):
    """analyze(devices=...) — independent device-pinned classifier
    replicas, each with its own dispatch thread — must produce results
    byte-identical to the single-device run (same weights, same programs,
    deterministic)."""
    dir_audio = _replica_env(tmp_path, monkeypatch)

    analyze(modelname='rm', dir_audio=dir_audio,
            dir_out=str(tmp_path / 'single'), chunklength=2.0,
            verbosity_print='ERROR')
    a = analyze(modelname='rm', dir_audio=dir_audio,
                dir_out=str(tmp_path / 'replicas'), chunklength=2.0,
                verbosity_print='ERROR', devices=['cpu'] * 4, n_streamers=2)

    # one dispatch thread per replica, each pinned to its device
    assert a.coordinator.analyzers_total == 4
    assert a.replica_models is not None and len(a.replica_models) == 4
    pinned = [m._device for m in a.replica_models]
    assert pinned == [CPU] * 4
    for m in a.replica_models:  # params really live on the pinned device
        arr = next(iter(m.classifier.params['yamnet'].values()))
        assert arr.device == m._device

    for i in range(5):
        got = open(tmp_path / 'replicas' / f'r{i}_buzzdetect.csv').read()
        want = open(tmp_path / 'single' / f'r{i}_buzzdetect.csv').read()
        assert got == want, f'replica-mode results differ for r{i}'


def test_analyze_devices_and_mesh_mutually_exclusive(tmp_path, monkeypatch):
    dir_audio = _replica_env(tmp_path, monkeypatch, n_files=1)
    with pytest.raises(ValueError, match='mutually exclusive'):
        analyze(modelname='rm', dir_audio=dir_audio,
                dir_out=str(tmp_path / 'out'), devices=['cpu'] * 2,
                mesh=make_mesh(devices=['cpu'] * 4, device='cpu'))


# --- multi-host data parallelism (analyze(host_shard=...)) -------------------

def test_analyze_host_shard_concurrent_hosts(tmp_path, monkeypatch):
    """Two CONCURRENT 'hosts' (separate processes), one shared output
    directory, zero coordination: each analyzes its stable hash shard of
    the corpus; together they complete every file, byte-identical to a
    single-host run — the §2c multi-host story attested end to end."""
    import os
    import subprocess
    import sys
    dir_audio = _replica_env(tmp_path, monkeypatch, n_files=6)
    dir_models = str(tmp_path / 'models')
    dir_out = str(tmp_path / 'shared_out')
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env.update(CHILD_ENV, BUZZDETECT_DIR_MODELS=dir_models)

    def host(h):
        return subprocess.Popen(
            [sys.executable, '-m', 'buzzdetect_torch', '--modelname', 'rm',
             '--dir_audio', dir_audio, '--dir_out', dir_out,
             '--chunklength', '2', '--verbosity_print', 'ERROR',
             '--device', 'cpu', '--host_shard', f'{h}/2'],
            cwd=repo, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE)

    procs = [host(h) for h in range(2)]
    children = []   # each child's exit code and the tail of its stderr
    try:
        for h, p in enumerate(procs):
            _out, err = p.communicate(timeout=CHILD_TIMEOUT)
            children.append(f'host {h}: exit {p.returncode}, stderr '
                            f'{err.decode()[-2000:]!r}')
            assert p.returncode == 0, children[-1]
    finally:
        for p in procs:
            p.kill()

    # a fresh single-host oracle
    analyze(modelname='rm', dir_audio=dir_audio,
            dir_out=str(tmp_path / 'oracle'), chunklength=2.0,
            verbosity_print='ERROR')
    for i in range(6):
        got = open(os.path.join(dir_out, f'r{i}_buzzdetect.csv')).read()
        want = open(tmp_path / 'oracle' / f'r{i}_buzzdetect.csv').read()
        assert got == want, (f'host-sharded result differs for r{i}; '
                             + '; '.join(children))
    leftovers = [f for f in os.listdir(dir_out) if f.endswith('_buzzpart.csv')]
    assert leftovers == [], '; '.join(children)

    # the shard partition is complete and disjoint: rerunning either host
    # over the finished dir exits 'fully analyzed' without touching files
    before = {f: os.path.getmtime(os.path.join(dir_out, f))
              for f in os.listdir(dir_out) if f.endswith('.csv')}
    p = host(0)
    try:
        _out, err = p.communicate(timeout=CHILD_TIMEOUT)
    finally:
        p.kill()
    rerun = f'host 0 rerun: exit {p.returncode}, stderr {err.decode()[-2000:]!r}'
    assert p.returncode == 0, rerun
    after = {f: os.path.getmtime(os.path.join(dir_out, f))
             for f in os.listdir(dir_out) if f.endswith('.csv')}
    assert before == after, rerun


def test_host_shard_validation():
    from buzzdetect_torch.analysis import Analyzer
    with pytest.raises(ValueError, match='host_shard'):
        Analyzer(modelname='whatever', host_shard=(4, 2),
                 model=object.__new__(object))
    # non-tuple misuse must hit the crafted message, not a raw unpack
    # TypeError: host_shard=1 ("host 1"?) and the CLI-style string '0/4'
    # are the likely API typos
    for bad in (1, '0/4', (0,), (0, 2, 4), (0.0, 2), (True, 2)):
        with pytest.raises(ValueError, match='host_shard must be'):
            Analyzer(modelname='whatever', host_shard=bad,
                     model=object.__new__(object))


def test_resolve_replica_devices_rejects_stray_strings():
    """devices='4' (Python API misuse) must fail at validation, not fall
    through to list('4') and die deep inside a copy to the device."""
    from buzzdetect_torch.parallel import resolve_replica_devices
    with pytest.raises(ValueError):
        resolve_replica_devices('4', 'cpu')
    with pytest.raises(ValueError):
        resolve_replica_devices(True, 'cpu')


def test_host_shard_composes_with_replica_devices(tmp_path, monkeypatch):
    """The two scale-out axes compose: a host analyzing its corpus shard
    can still fan its chunks across per-device replicas; union of both
    hosts' sharded+replicated runs equals the single-host oracle."""
    import os
    dir_audio = _replica_env(tmp_path, monkeypatch, n_files=4)
    dir_out = str(tmp_path / 'out')

    for host in range(2):
        a = analyze(modelname='rm', dir_audio=dir_audio, dir_out=dir_out,
                    chunklength=2.0, verbosity_print='ERROR',
                    host_shard=(host, 2), devices=['cpu'] * 2,
                    n_streamers=1)
        assert a.coordinator.analyzers_total == 2

    analyze(modelname='rm', dir_audio=dir_audio,
            dir_out=str(tmp_path / 'oracle'), chunklength=2.0,
            verbosity_print='ERROR')
    for i in range(4):
        got = open(os.path.join(dir_out, f'r{i}_buzzdetect.csv')).read()
        want = open(tmp_path / 'oracle' / f'r{i}_buzzdetect.csv').read()
        assert got == want


def test_replicas_compose_with_mulaw_and_device_resample(tmp_path,
                                                         monkeypatch):
    """Triple composition: per-device replicas x mu-law wire x on-device
    resampling (48 kHz source) equals the single-device run with the same
    wire configuration."""
    import os
    from buzzdetect_torch import config as cfg
    from buzzdetect_torch.models.convert import build_model_bundle
    from tests.audio_fixtures import make_tone, write_wav

    dir_models = tmp_path / 'models'
    build_model_bundle(str(dir_models / 'rc'), classes=['a', 'ins_buzz'],
                       seed=13)
    monkeypatch.setattr(cfg, 'DIR_MODELS', str(dir_models))
    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    for i in range(2):
        write_wav(dir_audio / f'hi{i}.wav', make_tone(3.0, 48000, 500 + i * 70),
                  48000)

    kw = dict(modelname='rc', dir_audio=str(dir_audio), chunklength=2.0,
              verbosity_print='ERROR', transfer_dtype='mulaw',
              resample_on_device=True)
    analyze(dir_out=str(tmp_path / 'single'), **kw)
    analyze(dir_out=str(tmp_path / 'replicas'), devices=['cpu'] * 2, **kw)
    for i in range(2):
        got = open(os.path.join(tmp_path, 'replicas',
                                f'hi{i}_buzzdetect.csv')).read()
        want = open(os.path.join(tmp_path, 'single',
                                 f'hi{i}_buzzdetect.csv')).read()
        assert got == want


def test_multiple_dispatch_threads_per_replica(tmp_path, monkeypatch):
    """In replica mode analyzers_cpu means dispatch threads PER replica
    (the per-device version of the reference's 'multiple GPU analyzers'
    knob): 2 replicas x analyzers_cpu=2 -> 4 threads sharing 2
    device-pinned classifiers, results still byte-identical."""
    import os
    dir_audio = _replica_env(tmp_path, monkeypatch, n_files=4)

    analyze(modelname='rm', dir_audio=dir_audio,
            dir_out=str(tmp_path / 'single'), chunklength=2.0,
            verbosity_print='ERROR')
    a = analyze(modelname='rm', dir_audio=dir_audio,
                dir_out=str(tmp_path / 'multi'), chunklength=2.0,
                verbosity_print='ERROR', devices=['cpu'] * 2,
                analyzers_cpu=2)
    assert a.coordinator.analyzers_total == 4
    assert len(a.replica_models) == 4
    assert len({id(m) for m in a.replica_models}) == 2  # 2 shared replicas
    devices_used = [m._device for m in a.replica_models]
    assert devices_used == sorted(devices_used, key=str)  # grouped by device

    for i in range(4):
        got = open(os.path.join(tmp_path, 'multi',
                                f'r{i}_buzzdetect.csv')).read()
        want = open(os.path.join(tmp_path, 'single',
                                 f'r{i}_buzzdetect.csv')).read()
        assert got == want


def test_full_train_checkpoint_resume_on_mesh(tmp_path):
    """Training checkpoints compose with a mesh: a DPxTP fine-tune
    interrupted at epoch 1 and resumed on the mesh lands on the same
    parameters as the uninterrupted mesh run (the checkpoint holds the
    master parameters of the mesh's first device, and the resume copies
    them out again)."""
    from buzzdetect_torch.train.clips import train_full_model
    mesh = _mesh_2d(4, 2)
    rng = np.random.default_rng(3)
    clips = (rng.standard_normal((8, 15600)) * 0.1).astype(np.float32)
    labels = (rng.random((8, 2)) > 0.5).astype(np.float32)
    kw = dict(batch_size=4, learning_rate=1e-3, log=lambda *_: None,
              mesh=mesh, device='cpu')

    gold_raw, gold_head, gold_losses = train_full_model(
        clips, labels, epochs=2, **kw)
    ckpt = str(tmp_path / 'work')
    train_full_model(clips, labels, epochs=1, checkpoint_dir=ckpt, **kw)
    raw, head, losses = train_full_model(
        clips, labels, epochs=2, checkpoint_dir=ckpt, **kw)

    assert losses == gold_losses
    for k in gold_raw:
        np.testing.assert_allclose(raw[k], gold_raw[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    for k in gold_head:
        np.testing.assert_allclose(head[k], gold_head[k], rtol=0, atol=1e-6,
                                   err_msg=k)
