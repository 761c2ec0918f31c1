"""The port's ``mesh=`` (``buzzdetect_torch/parallel/mesh.py``, the
classifier's and the trainer's splits over a device mesh) against the JAX
package's on the CPU, case for case with tests/test_parallel.py's mesh
tests.

The JAX package runs its mesh over 8 virtual CPU devices
(tests/conftest.py); the port's meshes repeat the one CPU (``['cpu'] *
8``), as on one card they repeat ``'cuda:0'``. That checks the arithmetic
of every split (the patch axis, the ragged and the empty shard, the
gather, BatchNorm over data shards, the head's 1024-feature contraction
over ``'model'`` with its partial sums); copies between two devices do not
happen here.

Tolerances, and why:

* scores: 1e-4, the JAX test's own bound for a mesh against one device
  (exact f32 on both sides; on the CPU each patch's row reads the same
  bits whatever its shard);
* ``analyze(mesh=)`` CSVs: byte-identical to one device on the same conv
  path, as the JAX test holds them;
* first-step gradients: 1e-4 of each leaf's max |g| of a float64
  evaluation along the run's own ReLU branches (tests/test_torch_train.py
  gives the reasons), the mesh against one device within 1e-4 of max |g|
  where both take the same branches, and against the JAX mesh step within
  1e-4 where the JAX package is itself within 1e-4 of float64;
* the head's mesh steps: losses rtol 1e-5 and parameters within 2 k 1e-5 lr
  after k steps of the JAX package's (tests/test_torch_train.py);
* resume on a mesh: bit-identical.

Each case prints its max |port - reference|.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from buzzdetect_tpu.models import heads as jheads
from buzzdetect_tpu.models import yamnet as jyam
from buzzdetect_tpu.models.classifier import ChunkClassifier as JaxClassifier
from buzzdetect_tpu.parallel import make_mesh as jax_make_mesh
from buzzdetect_tpu.train import trainer as jtrainer
from buzzdetect_torch import config as tcfg
from buzzdetect_torch.analysis import analyze
from buzzdetect_torch.models import yamnet as tyam
from buzzdetect_torch.models.classifier import ChunkClassifier
from buzzdetect_torch.models.convert import build_model_bundle
from buzzdetect_torch.models.registry import load_model
from buzzdetect_torch.models.weights import train_state_from_numpy
from buzzdetect_torch.ops.frontend import FrontendConfig, log_mel_patches
from buzzdetect_torch.parallel import (Mesh, data_sharding, gather, make_mesh,
                                       replicated_sharding, split)
from buzzdetect_torch.train import trainer as ttrainer
from buzzdetect_torch.train.clips import train_full_model
from tests.audio_fixtures import make_tone, write_wav
from tests.test_torch_train import (Z_EDGE, _branch_edges, _clips,
                                    _embed_f64, _ReluMasks, _share)

CPU8 = ['cpu'] * 8
LR = 1e-3


def _mesh_2d(data, model):
    return make_mesh(devices=['cpu'] * (data * model), shape=(data, model),
                     axes=('data', 'model'), device='cpu')


def _jax_mesh_2d(data, model):
    return jax.sharding.Mesh(
        np.array(jax.devices()[:data * model]).reshape(data, model),
        ('data', 'model'))


@pytest.fixture(scope='module', autouse=True)
def two_torch_threads():
    """Two intra-op threads for this module's full-width CPU steps: the
    test run shares the machine's cores among its workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope='module')
def arrays():
    raw = jyam.init_raw_params(seed=4)
    folded = jyam.fold_batchnorm(raw)
    a = {f'yamnet/{k}': v for k, v in folded.items()}
    a.update(jheads.init_head(1024, 5, seed=4))
    return a


# --- the mesh -----------------------------------------------------------------

def test_mesh_construction():
    """tests/test_parallel.py:27. An int counts the attached devices of
    ``device``'s type (the one CPU here) and raises past them, where JAX
    would quietly build a smaller mesh; an explicit list may repeat a
    device; CUDA without a card raises."""
    mesh = make_mesh(devices=CPU8, device='cpu')
    assert mesh.devices.shape == (8,)
    assert mesh.axis_names == ('data',)
    assert mesh.device_type == 'cpu' and mesh.first() == torch.device('cpu')
    assert jax_make_mesh(8).axis_names == mesh.axis_names
    assert make_mesh(device='cpu').devices.shape == (1,)
    assert make_mesh(devices=CPU8, n_devices=3, device='cpu'
                     ).devices.shape == (3,)
    with pytest.raises(ValueError, match='only 1 local cpu device'):
        make_mesh(2, device='cpu')
    with pytest.raises(ValueError, match='only 0 CUDA'):
        make_mesh(devices=['cuda:0'], device='cpu')
    with pytest.raises(RuntimeError, match='CUDA'):
        make_mesh(devices=['cuda', 'cuda'])
    with pytest.raises(RuntimeError, match='no cuda device'):
        make_mesh()
    with pytest.raises(ValueError, match='not a device'):
        make_mesh(devices=['gpu7'], device='cpu')
    print('max |port - reference| = n/a (mesh shapes and refusals)')


def test_make_mesh_2d_for_trainer():
    """tests/test_parallel.py:160: the ('data', 'model') mesh the trainer's
    sharding requires, and its sub-meshes."""
    mesh = make_mesh(devices=CPU8, shape=(4, 2), axes=('data', 'model'),
                     device='cpu')
    assert mesh.axis_names == ('data', 'model')
    assert mesh.devices.shape == (4, 2)
    assert mesh.shape == {'data': 4, 'model': 2}
    assert len(mesh.axis_devices('data')) == 4
    assert mesh.take('data', 1).axis_names == ('model',)
    with pytest.raises(ValueError, match='axes must name every dim'):
        make_mesh(devices=CPU8, shape=(4, 2), axes=('data',), device='cpu')
    with pytest.raises(ValueError, match='needs 16 devices'):
        make_mesh(devices=CPU8, shape=(4, 4), axes=('data', 'model'),
                  device='cpu')
    with pytest.raises(ValueError, match="no 'model' axis"):
        make_mesh(devices=CPU8, device='cpu').axis_size('model')
    jmesh = jax_make_mesh(shape=(4, 2), axes=('data', 'model'))
    assert jmesh.devices.shape == mesh.devices.shape
    print('max |port - reference| = n/a (mesh shapes)')


@pytest.mark.parametrize('n', [16, 7, 3, 0])
def test_split_and_gather(n):
    """``split`` cuts contiguous ceil(n / size) slices, as GSPMD pads a
    ragged axis (the last slices short or empty), and ``gather`` joins
    them back in order; the sharding descriptors name the mesh and the
    split dimension."""
    mesh = make_mesh(devices=CPU8, device='cpu')
    x = torch.arange(n * 3, dtype=torch.float32).reshape(n, 3)
    parts = split(x, mesh, 'data', 0)
    step = -(-n // 8)
    assert [len(p) for p in parts] == [max(0, min(step, n - i * step))
                                       for i in range(8)]
    assert torch.equal(gather(parts, 0, 'cpu'), x)
    cols = split(x, make_mesh(devices=['cpu'] * 2, device='cpu'), 'data', 1)
    assert [p.shape[1] for p in cols] == [2, 1]
    assert torch.equal(gather(cols, 1, 'cpu'), x)
    assert data_sharding(mesh, 3).spec == ('data', None, None)
    assert data_sharding(mesh, 2, sharded_dim=1).mesh is mesh
    assert replicated_sharding(mesh).spec == ()
    print('max |port - reference| = 0 (slices exact)')


# --- sharded inference -----------------------------------------------------------

@pytest.mark.parametrize('seconds', [9.6, 6.7], ids=['even', 'ragged'])
def test_sharded_inference_matches_single(arrays, seconds):
    """tests/test_parallel.py:33 and :45: 10 patches, and 7 patches over 8
    devices (a ragged and an empty shard). The port's mesh run against its
    one-device run (the conv kernels' plain versions) and against the JAX
    package's mesh run of the same arrays on its 8 virtual devices."""
    wav = (np.random.default_rng(0).standard_normal(int(seconds * 16000))
           * 0.1).astype(np.float32)
    single = ChunkClassifier(arrays, device='cpu').predict(wav)
    sharded = ChunkClassifier(arrays, device='cpu',
                              mesh=make_mesh(devices=CPU8, device='cpu')
                              ).predict(wav)
    jax_sharded = JaxClassifier(arrays, framehop_prop=1.0,
                                mesh=jax_make_mesh(8)).predict(wav)
    assert sharded.shape == single.shape == jax_sharded.shape
    np.testing.assert_allclose(sharded, single, atol=1e-4)
    np.testing.assert_allclose(sharded, jax_sharded, atol=1e-4)
    print(f'{len(sharded)} patches: max |mesh - one device| = '
          f'{np.abs(sharded - single).max()}; max |port - reference| = '
          f'{np.abs(sharded - jax_sharded).max()}')


def test_every_entry_point_splits(arrays):
    """``predict_async_batch`` (the flattened B x P axis), ``embed`` and
    ``classify_resident`` on a mesh, a 2-D mesh (its 'model' axis
    replicated) and ``sharding=`` (run as its mesh) against one device's
    XLA conv path, which a mesh runs: scores within 1e-4, embeddings
    within 1e-5 of their largest (one conv on fewer patches may sum in
    another order)."""
    rng = np.random.default_rng(1)
    wavs = [(rng.standard_normal(int(s * 16000)) * 0.1).astype(np.float32)
            for s in (6.7, 2.0, 0.5)]
    one = ChunkClassifier(arrays, device='cpu', conv='xla')
    mesh = make_mesh(devices=CPU8, device='cpu')
    worst = 0.0
    for clf in (ChunkClassifier(arrays, device='cpu', mesh=mesh),
                ChunkClassifier(arrays, device='cpu', mesh=_mesh_2d(3, 2)),
                ChunkClassifier(arrays, device='cpu',
                                sharding=data_sharding(mesh, 1))):
        assert clf.mesh is not None and clf.conv == 'xla'
        got, n_valid = clf.predict_async_batch(wavs)
        want, n_want = one.predict_async_batch(wavs)
        assert n_valid == n_want
        assert float((got - want).abs().max()) <= 1e-4
        emb, emb_one = clf.embed(wavs[0]), one.embed(wavs[0])
        assert np.abs(emb - emb_one).max() <= 1e-5 * np.abs(emb_one).max()
        wire = torch.from_numpy(np.zeros(16000 * 3, np.float32))
        assert float((clf.classify_resident(wire)
                      - one.classify_resident(wire)).abs().max()) <= 1e-4
        worst = max(worst, float((got - want).abs().max()))
    print(f'scores max |mesh - one device| = {worst}')


def test_conv_resolution_with_mesh(arrays):
    """tests/test_pallas_conv.py:311-327: 'auto' with a mesh or a sharding
    resolves to 'xla' (and 'auto' precision to 'high'); an explicit
    'pallas' with either raises naming the mesh, at the classifier and at
    ``load_model`` in the caller's thread; a device of another type than
    the mesh's raises, and so does a mesh without a 'data' axis (as the
    JAX package's ``PartitionSpec('data', ...)`` does)."""
    mesh = make_mesh(devices=['cpu'] * 2, device='cpu')
    assert ChunkClassifier(arrays, device='cpu').conv == 'pallas'
    with pytest.raises(ValueError, match='conv must be'):
        ChunkClassifier(arrays, device='cpu', conv='fused')
    for kw in ({'mesh': mesh}, {'sharding': data_sharding(mesh)}):
        with pytest.raises(ValueError, match='mesh'):
            ChunkClassifier(arrays, device='cpu', conv='pallas', **kw)
        clf = ChunkClassifier(arrays, device='cpu', **kw)
        assert (clf.conv, clf.conv_precision) == ('xla', 'high')
        assert clf.device == torch.device('cpu')
    with pytest.raises(ValueError, match="pass device='cpu'"):
        ChunkClassifier(arrays, mesh=mesh)
    with pytest.raises(ValueError, match="no 'data' axis"):
        ChunkClassifier(arrays, device='cpu', mesh=make_mesh(
            devices=['cpu'] * 2, axis='model', device='cpu'))
    with pytest.raises(ValueError, match='different meshes'):
        ChunkClassifier(arrays, device='cpu', mesh=mesh,
                        sharding=data_sharding(make_mesh(device='cpu')))
    with pytest.raises(ValueError, match='mesh'):
        load_model('model_general_v3', conv='pallas', mesh=mesh,
                   device='cpu')
    jmesh = jax_make_mesh()
    assert JaxClassifier(arrays, mesh=jmesh).conv == 'xla'
    with pytest.raises(ValueError, match='mesh'):
        JaxClassifier(arrays, conv='pallas', mesh=jmesh)
    print('max |port - reference| = n/a (resolution rules)')


# --- analyze(mesh=) -----------------------------------------------------------------

def _bundles(tmp_path, monkeypatch):
    """'pm' and 'pm_xla', the same seeded bundle, the second's config
    saying ``"conv": "xla"``."""
    dir_models = tmp_path / 'models'
    build_model_bundle(str(dir_models / 'pm'), classes=['a', 'ins_buzz'],
                       seed=9)
    shutil.copytree(dir_models / 'pm', dir_models / 'pm_xla')
    path = dir_models / 'pm_xla' / 'config_model.json'
    path.write_text(json.dumps({**json.loads(path.read_text()),
                                'conv': 'xla'}))
    monkeypatch.setattr(tcfg, 'DIR_MODELS', str(dir_models))


def test_analyze_with_mesh(tmp_path, monkeypatch):
    """tests/test_parallel.py:116: ``analyze(mesh=...)`` splits each chunk's
    patch axis across 8 devices; its CSV is byte-identical to one device
    on the same conv path (the bundle variant whose config says ``"conv":
    "xla"``), and equal after the 2-digit rounding to the default run on
    the conv kernels' plain versions. The worker names the mesh."""
    _bundles(tmp_path, monkeypatch)
    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    write_wav(dir_audio / 't.wav', make_tone(4.0, 16000), 16000)
    kw = dict(dir_audio=str(dir_audio), chunklength=4.0,
              verbosity_print='ERROR', device='cpu')
    analyze(modelname='pm_xla', dir_out=str(tmp_path / 'single'), **kw)
    analyze(modelname='pm', dir_out=str(tmp_path / 'default'), **kw)
    mesh = make_mesh(devices=CPU8, device='cpu')
    result = analyze(modelname='pm', dir_out=str(tmp_path / 'meshed'),
                     mesh=mesh, **kw)
    assert result.model.classifier.mesh is mesh
    a = open(tmp_path / 'single' / 't_buzzdetect.csv').read()
    b = open(tmp_path / 'meshed' / 't_buzzdetect.csv').read()
    c = open(tmp_path / 'default' / 't_buzzdetect.csv').read()
    assert a == b
    tables = [np.array([ln.split(',') for ln in t.splitlines()[1:]], float)
              for t in (b, c)]
    worst = float(np.abs(tables[0] - tables[1]).max())
    assert worst <= 0.0101
    log = open(next((tmp_path / 'meshed').glob('*.log'))).read()
    assert '8-device mesh (CPU)' in log
    print(f'meshed CSV byte-identical to one device on the XLA conv path; '
          f'max |port - reference| = {worst} against the default run after '
          f'2-digit rounding')


def test_analyze_devices_and_mesh_mutually_exclusive(tmp_path, monkeypatch):
    """tests/test_parallel.py:236, with ``devices=2`` as the JAX case
    passes; a mesh of another device type than ``device`` is a ValueError
    too. Both before any model loads."""
    _bundles(tmp_path, monkeypatch)
    run = dict(modelname='pm', dir_audio=str(tmp_path),
               dir_out=str(tmp_path / 'out'))
    mesh = make_mesh(devices=['cpu'] * 4, device='cpu')
    with pytest.raises(ValueError, match='mutually exclusive'):
        analyze(devices=2, mesh=mesh, device='cpu', **run)
    with pytest.raises(ValueError, match="pass device='cpu'"):
        analyze(mesh=mesh, **run)
    assert not (tmp_path / 'out').exists()
    print('max |port - reference| = n/a (refusals)')


# --- training on a mesh -------------------------------------------------------------

def _head_data(n=64, seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, 1024)).astype(np.float32)
    labels = (rng.random((n, 3)) > 0.7).astype(np.float32)
    return emb, labels


def test_head_train_step_dp_tp():
    """tests/test_parallel.py:68: ``train_head`` on a 4 x 2 ('data',
    'model') mesh: the head's shape, a falling loss, and the JAX package's
    mesh run of the same batches (losses rtol 1e-5, parameters within
    2 k 1e-5 lr after k steps), and the port's one-device run."""
    emb, labels = _head_data()
    params, losses = ttrainer.train_head(emb, labels, epochs=3,
                                         batch_size=32, mesh=_mesh_2d(4, 2),
                                         learning_rate=LR, device='cpu')
    assert params['head/kernel'].shape == (1024, 3)
    assert losses[-1] < losses[0]
    jmesh = _jax_mesh_2d(4, 2)
    with jmesh:
        j_params, j_losses = jtrainer.train_head(
            emb, labels, epochs=3, batch_size=32, mesh=jmesh,
            learning_rate=LR)
    one, one_losses = ttrainer.train_head(emb, labels, epochs=3,
                                          batch_size=32, learning_rate=LR,
                                          device='cpu')
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    np.testing.assert_allclose(losses, one_losses, rtol=1e-5)
    k, worst = len(losses), 0.0
    for key in j_params:
        err = float(np.abs(params[key] - j_params[key]).max())
        assert err <= 2 * k * 1e-5 * LR, key
        assert np.abs(params[key] - one[key]).max() <= 2 * k * 1e-5 * LR
        worst = max(worst, err)
    print(f'{k} steps: max |port - reference| = {worst} (bound '
          f'{2 * k * 1e-5 * LR})')


def test_full_train_step_runs_and_learns():
    """tests/test_parallel.py:97: the full step on a 4 x 2 mesh, 4 clips (one
    patch on each data shard), 5 steps: finite and falling losses."""
    rng = np.random.default_rng(2)
    params, opt = ttrainer.init_full_train(3, learning_rate=1e-3,
                                           device='cpu')
    step = ttrainer.make_full_train_step(opt, params, mesh=_mesh_2d(4, 2))
    wav = torch.from_numpy((rng.standard_normal((4, 15600))
                            * 0.1).astype(np.float32))
    labels = np.zeros((4, 3), np.float32)
    labels[:2, 0] = 1
    losses = [float(step(wav, torch.from_numpy(labels))) for _ in range(5)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    print(f'losses {losses}; max |port - reference| = n/a (learning)')


def test_train_steps_need_a_model_axis():
    """A mesh without a 'model' axis: the JAX steps raise ValueError naming
    the axis (their PartitionSpec('data', 'model')), and so do the port's,
    at every training entry point."""
    emb, labels = _head_data(8)
    jmesh = jax_make_mesh(4)
    with pytest.raises(ValueError, match='model'):
        jtrainer.train_head(emb, labels, epochs=1, batch_size=4, mesh=jmesh)
    mesh = make_mesh(devices=['cpu'] * 4, device='cpu')
    params, opt = ttrainer.init_full_train(3, device='cpu')
    calls = (lambda: ttrainer.train_head(emb, labels, mesh=mesh,
                                         device='cpu'),
             lambda: ttrainer.make_head_train_step(opt, params['head'],
                                                   mesh=mesh),
             lambda: ttrainer.make_full_train_step(opt, params, mesh=mesh),
             lambda: train_full_model(*_clips(2), mesh=mesh, device='cpu'))
    for call in calls:
        with pytest.raises(ValueError, match="no 'model' axis"):
            call()
    print('max |port - reference| = n/a (refusals)')


@pytest.mark.parametrize('n_clips,data', [(4, 2), (3, 4)],
                         ids=['even', 'ragged'])
def test_embed_train_shards_match_one_batch(n_clips, data):
    """``yamnet.embed_train`` on data shards (2 + 2 clips, and 1 + 1 + 1 + 0
    with an empty shard) against the batch in one piece: the empty shard's
    empty embeddings; BatchNorm statistics within 2e-6 of max(1, |s|) (f32
    rounding of a statistic combined in another order); embeddings within
    1e-4 of their largest, the f32 rounding of 27 layers of convolution
    and BatchNorm on other batch sizes (the JAX package's own f32
    embeddings lie 5.7e-5 from float64). A statistic that counted the empty
    shard, or missed one, would move them by percents."""
    wav, _labels = _clips(n_clips)
    patches = log_mel_patches(torch.from_numpy(wav), FrontendConfig())
    patches = patches.reshape(n_clips, 96, 64)
    params, _opt = train_state_from_numpy(jyam.init_raw_params(seed=0))
    whole, stats = tyam.embed_train(params, patches)
    mesh = make_mesh(devices=['cpu'] * data, device='cpu')
    shards = split(patches, mesh, 'data', 0)
    parts, shard_stats = tyam.embed_train([params] * data, shards)
    assert [len(p) for p in parts] == [len(s) for s in shards]
    got = torch.cat(parts)
    err = float((got - whole).detach().abs().max())
    assert err <= 1e-4 * float(whole.detach().abs().max())
    worst = 0.0
    for k, v in stats.items():
        d = float((shard_stats[k] - v).abs().max())
        assert d <= 2e-6 * max(1.0, float(v.abs().max())), k
        worst = max(worst, d)
    print(f'embeddings max |shards - one batch| = {err}; statistics '
          f'{worst}')


def _recording_tx():
    """An optax transformation that moves nothing and keeps the gradients
    as its state: the JAX mesh step's first-step gradients, read off the
    step itself."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, _state, _p=None: (jax.tree.map(jnp.zeros_like, g), g))


@pytest.mark.parametrize('n_clips,shape', [(4, (2, 2)), (3, (4, 2))],
                         ids=['even', 'ragged'])
def test_full_step_mesh_gradients_match_jax(n_clips, shape):
    """The first step's gradients from one numpy state: the port's mesh
    step (its ReLU branches recorded per shard, joined in clip order)
    against float64 along those branches (1e-4 of each leaf's max |g|),
    against the port's one-device step wherever both took the same
    branches, and against the JAX package's mesh step (``make_full_train_
    step(tx, mesh=)`` with a transformation that keeps the gradients)
    where the JAX package is within 1e-4 of float64's own run: within
    that distance plus 1e-4 (each side's own rounding, as
    tests/test_torch_train.py holds the Adam moments)."""
    wav, labels = _clips(n_clips)
    j_params, _opt, _tx = jtrainer.init_full_train(2, seed=0)
    state = jax.tree.map(np.array, j_params)   # copied: the step donates
    jmesh = _jax_mesh_2d(*shape)
    tx = _recording_tx()
    j_step = jtrainer.make_full_train_step(tx, mesh=jmesh)
    with jmesh:
        _p, j_grads, _loss = j_step(j_params, tx.init(j_params),
                                    jnp.asarray(wav), jnp.asarray(labels))
    j_grads = {f'{g}.{k}': np.asarray(v) for g, leaves in j_grads.items()
               for k, v in leaves.items()}

    runs = {}
    for name, mesh in (('mesh', _mesh_2d(*shape)), ('one', None)):
        params, opt = train_state_from_numpy(state)
        with _ReluMasks() as rec:
            loss, _stats = ttrainer.full_loss(
                params, torch.from_numpy(wav), torch.from_numpy(labels),
                FrontendConfig(), mesh=mesh)
        loss.backward()
        per_layer = len(rec.masks) // 27
        masks = [torch.cat(rec.masks[i * per_layer:(i + 1) * per_layer])
                 for i in range(27)]
        runs[name] = (float(loss.detach()), masks, {
            p: t.grad.numpy() for p, t in ttrainer.trainable_leaves(params)})
    loss, masks, grads = runs['mesh']
    assert loss == pytest.approx(runs['one'][0], rel=1e-5)

    patches = log_mel_patches(torch.from_numpy(wav), FrontendConfig())
    patches = patches.reshape(n_clips, 96, 64).double()
    y64 = torch.from_numpy(labels).double()

    def f64(masks=None):
        leaves = {p: torch.from_numpy(v.astype(np.float64)).requires_grad_()
                  for p, v in ((f'{g}.{k}', v) for g, d in state.items()
                               for k, v in d.items())
                  if not p.endswith(('bn_mean', 'bn_var'))}
        raw = {k.split('.', 1)[1]: t for k, t in leaves.items()
               if k.startswith('yamnet_raw.')}
        emb, zs = _embed_f64(raw, patches, masks)
        ttrainer.bce_with_logits_loss(
            emb @ leaves['head.head/kernel'] + leaves['head.head/bias'],
            y64).backward()
        return {k: t.grad.numpy() for k, t in leaves.items()}, zs

    same, zs = f64(masks)
    own, _zs = f64()
    edges = _branch_edges(zs, masks)
    assert edges[1] <= Z_EDGE
    branches_agree = all(torch.equal(a, b)
                         for a, b in zip(masks, runs['one'][1]))
    held = 0
    worst = dict(same=0.0, one=0.0, jax=0.0)
    for path, got in grads.items():
        err = _share(got, same[path], same[path])
        assert err <= 1e-4, path
        worst['same'] = max(worst['same'], err)
        if branches_agree:
            d = _share(got, runs['one'][2][path], same[path])
            assert d <= 1e-4, path
            worst['one'] = max(worst['one'], d)
        jax_err = _share(j_grads[path], own[path], own[path])
        if jax_err <= 1e-4:
            held += 1
            d = _share(got, j_grads[path], own[path])
            assert d <= jax_err + 1e-4, path
            worst['jax'] = max(worst['jax'], d)
    assert held >= 2   # the head at least
    print(f'mesh {shape}, {n_clips} clips: against float64 on the port\'s '
          f'branches ({edges[0]} differ, all at |z| <= {edges[1]:.3g}) '
          f'{worst["same"]}; against one device (branches '
          f'{"equal" if branches_agree else "differ"}) {worst["one"]}; '
          f'{held} of {len(grads)} leaves where the reference is within '
          f'1e-4 of float64: max |port - reference| / max |g| = '
          f'{worst["jax"]}')


def test_full_train_checkpoint_resume_on_mesh(tmp_path):
    """tests/test_parallel.py:411: a fine-tune on a 4 x 2 mesh interrupted
    at epoch 1 and resumed on the mesh lands on the uninterrupted mesh
    run's parameters and losses, bit for bit (the checkpoint holds the
    master parameters of the mesh's first device)."""
    rng = np.random.default_rng(3)
    clips = (rng.standard_normal((8, 15600)) * 0.1).astype(np.float32)
    labels = (rng.random((8, 2)) > 0.5).astype(np.float32)
    kw = dict(batch_size=4, learning_rate=1e-3, log=lambda *_: None,
              mesh=_mesh_2d(4, 2), device='cpu')
    gold_raw, gold_head, gold_losses = train_full_model(
        clips, labels, epochs=2, **kw)
    ckpt = str(tmp_path / 'work')
    train_full_model(clips, labels, epochs=1, checkpoint_dir=ckpt, **kw)
    raw, head, losses = train_full_model(clips, labels, epochs=2,
                                         checkpoint_dir=ckpt, **kw)
    assert losses == gold_losses
    for got, want in ((raw, gold_raw), (head, gold_head)):
        for k in want:
            assert np.array_equal(got[k], want[k]), k
    print(f'{len(raw) + len(head)} arrays bit-identical; max |port - '
          f'reference| = 0')


def test_mesh_class_checks_its_devices():
    """A mesh holds devices of one type, one name per dimension."""
    with pytest.raises(ValueError, match='one name per dimension'):
        Mesh(np.array(['cpu', 'cpu'], dtype=object), ('data', 'model'))
    with pytest.raises(ValueError, match='one name per dimension'):
        Mesh(np.empty((0,), dtype=object), ('data',))
    mesh = Mesh([['cpu', 'cpu']], ('data', 'model'))
    assert mesh.shape == {'data': 1, 'model': 2}
    print('max |port - reference| = n/a (refusals)')
