"""tests/test_score_embeddings.py, case for case, against
``buzzdetect_torch`` (import prefix changed, same assertions). Edits:
``analyze()`` and ``embed_directory`` run on the CPU (the module's
wrappers pass ``device='cpu'``); the tools run as ``python -m
buzzdetect_torch.tools.score_embeddings`` and ``embed_corpus`` with
``--device cpu`` from the repository's root (the JAX cases run
``tools/*.py``); bundles are built with the port's ``build_model_bundle``
and ``build_ensemble_bundle``; the reference's metrics table is found
beside ``TESTBUZZ``. The two cases that compare a rescored CSV with
``analyze()`` also run the JAX package's ``analyze()`` on the same audio and
bundle and print max |port - JAX| over the CSV scores.

The JAX package's docstring:
Scoring cached embeddings: embed once, iterate heads for free.

The contract under test: embed_directory + tools/score_embeddings.py
reproduces a full analyze() run's result files — same schema, same
rounding, same manifest — without touching the audio again.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from buzzdetect_torch import config as cfg
from buzzdetect_torch.models.convert import build_model_bundle
from tests.audio_fixtures import make_tone, write_wav
from tests.test_reference_equivalence import TESTBUZZ

CLASSES = ['ins_buzz', 'ambient_noise', 'human']
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = ['-m', 'buzzdetect_torch.tools.score_embeddings', '--device', 'cpu']
TOOL_EMBED = ['-m', 'buzzdetect_torch.tools.embed_corpus', '--device', 'cpu']
# the reference snapshot's metrics table, where the snapshot is mounted
METRICS = os.path.join(os.path.dirname(os.path.dirname(TESTBUZZ)), 'models',
                       'model_general_v3', 'tests', 'metrics.csv')


def analyze(**kw):
    """The port's analyze(), on the CPU."""
    from buzzdetect_torch import analysis
    kw.setdefault('device', 'cpu')
    return analysis.analyze(**kw)


def embed_directory(*a, **kw):
    """The port's embed_directory, on the CPU."""
    from buzzdetect_torch.train import embed_corpus
    kw.setdefault('device', 'cpu')
    return embed_corpus.embed_directory(*a, **kw)


def _vs_jax(dir_models, dir_audio, dir_port, rels, tmp_path):
    """The JAX package's analyze() of the same audio and bundle; prints
    max |port - JAX| over the port's rescored CSV scores."""
    from buzzdetect_tpu import analysis as janalysis
    from buzzdetect_tpu import config as jcfg
    saved = jcfg.DIR_MODELS
    jcfg.DIR_MODELS = str(dir_models)
    try:
        janalysis.analyze(modelname='scoremodel', dir_audio=str(dir_audio),
                          dir_out=str(tmp_path / 'jax'),
                          verbosity_print='ERROR')
    finally:
        jcfg.DIR_MODELS = saved
    err = 0.0
    for rel in rels:
        name = rel + cfg.SUFFIX_RESULT_COMPLETE
        port = np.loadtxt(os.path.join(dir_port, name), delimiter=',',
                          skiprows=1, ndmin=2)
        ref = np.loadtxt(tmp_path / 'jax' / name, delimiter=',',
                         skiprows=1, ndmin=2)
        assert port.shape == ref.shape
        err = max(err, float(np.abs(port - ref).max()))
    print(f'rescored embeddings: max |port - JAX analyze()| over CSV '
          f'scores = {err}')
    return err


@pytest.fixture(scope='module')
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp('score_env')
    dir_models = root / 'models'
    build_model_bundle(
        str(dir_models / 'scoremodel'), classes=CLASSES, seed=7,
        metrics_csv=METRICS if os.path.exists(METRICS) else None)
    dir_audio = root / 'audio'
    (dir_audio / 'sub').mkdir(parents=True)
    write_wav(dir_audio / 'a.wav', make_tone(4.0, 16000, 220), 16000)
    write_wav(dir_audio / 'sub' / 'b.wav', make_tone(3.0, 16000, 440), 16000)
    return {'models': str(dir_models), 'audio': str(dir_audio)}


def _run_tool(args):
    return subprocess.run([sys.executable] + TOOL + args, cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ,
                               'BUZZDETECT_DIR_MODELS': os.environ.get(
                                   'BUZZDETECT_DIR_MODELS', '')})


def test_score_embeddings_matches_analyze(env, tmp_path, monkeypatch):

    monkeypatch.setattr(cfg, 'DIR_MODELS', env['models'])
    monkeypatch.setenv('BUZZDETECT_DIR_MODELS', env['models'])

    golden = tmp_path / 'golden'
    analyze(modelname='scoremodel', dir_audio=env['audio'],
            dir_out=str(golden), verbosity_print='ERROR')

    emb = tmp_path / 'emb'
    embed_directory(env['audio'], str(emb), modelname='scoremodel',
                    log=lambda *a: None)

    out = tmp_path / 'rescored'
    proc = _run_tool(['--dir_embeddings', str(emb),
                      '--modelname', 'scoremodel', '--dir_out', str(out)])
    assert proc.returncode == 0, proc.stderr

    for rel in ('a', 'sub/b'):
        # BYTES, not read_text(): text mode translates newlines and would
        # mask a line-terminator mismatch with the finalizer's CRLF files
        g = (golden / (rel + cfg.SUFFIX_RESULT_COMPLETE)).read_bytes()
        s = (out / (rel + cfg.SUFFIX_RESULT_COMPLETE)).read_bytes()
        assert s == g, f'{rel}: rescored CSV differs from analyze()'

    m_g = json.loads((golden / 'buzzdetect_manifest.json').read_text())
    m_s = json.loads((out / 'buzzdetect_manifest.json').read_text())
    assert m_s == m_g
    _vs_jax(env['models'], env['audio'], out, ('a', 'sub/b'), tmp_path)


@pytest.mark.skipif(not os.path.exists(METRICS),
                    reason='reference metrics table not present')
def test_score_embeddings_detections_mode(env, tmp_path, monkeypatch):

    monkeypatch.setattr(cfg, 'DIR_MODELS', env['models'])
    monkeypatch.setenv('BUZZDETECT_DIR_MODELS', env['models'])

    golden = tmp_path / 'golden'
    analyze(modelname='scoremodel', dir_audio=env['audio'],
            dir_out=str(golden), precision=0.95, verbosity_print='ERROR')

    emb = tmp_path / 'emb'
    embed_directory(env['audio'], str(emb), modelname='scoremodel',
                    log=lambda *a: None)
    out = tmp_path / 'det'
    proc = _run_tool(['--dir_embeddings', str(emb),
                      '--modelname', 'scoremodel',
                      '--precision', '0.95', '--dir_out', str(out)])
    assert proc.returncode == 0, proc.stderr
    g = (golden / ('a' + cfg.SUFFIX_RESULT_COMPLETE)).read_bytes()
    s = (out / ('a' + cfg.SUFFIX_RESULT_COMPLETE)).read_bytes()
    assert s == g


def test_cross_model_rescore_warns_but_proceeds(env, tmp_path, monkeypatch):
    """Rescoring with a DIFFERENT head than the one that extracted the
    embeddings must print the shared-embedder caveat (naming the
    'embeddername' config key's value) and still produce results — heads
    only transfer within one embedding space, but a retrained sibling is a
    legitimate use. Regression: the warning used to key on a nonexistent
    'embedder' config entry and therefore never fired."""

    monkeypatch.setattr(cfg, 'DIR_MODELS', env['models'])
    monkeypatch.setenv('BUZZDETECT_DIR_MODELS', env['models'])
    build_model_bundle(os.path.join(env['models'], 'scoremodel_b'),
                       classes=CLASSES, seed=11)

    emb = tmp_path / 'emb'
    embed_directory(env['audio'], str(emb), modelname='scoremodel',
                    log=lambda *a: None)
    out = tmp_path / 'cross'
    proc = _run_tool(['--dir_embeddings', str(emb),
                      '--modelname', 'scoremodel_b', '--dir_out', str(out)])
    assert proc.returncode == 0, proc.stderr
    assert "extracted via model 'scoremodel'" in proc.stderr
    assert 'yamnet' in proc.stderr  # the embeddername, not a dead config key
    assert (out / ('a' + cfg.SUFFIX_RESULT_COMPLETE)).exists()

    # same head -> no caveat
    out2 = tmp_path / 'same'
    proc2 = _run_tool(['--dir_embeddings', str(emb),
                       '--modelname', 'scoremodel', '--dir_out', str(out2)])
    assert proc2.returncode == 0, proc2.stderr
    assert 'extracted via model' not in proc2.stderr


def test_score_embeddings_refuses_unpinned_dir(env, tmp_path, monkeypatch):
    """A directory of npz files WITHOUT the embeddings manifest must be
    refused — there is no attested frame grid to put in the result rows."""
    monkeypatch.setenv('BUZZDETECT_DIR_MODELS', env['models'])
    d = tmp_path / 'loose'
    d.mkdir()
    np.savez(d / 'x_embeddings.npz', starts=np.zeros(1),
             embeddings=np.zeros((1, 1024), np.float32))
    proc = _run_tool(['--dir_embeddings', str(d),
                      '--modelname', 'scoremodel',
                      '--dir_out', str(tmp_path / 'out')])
    assert proc.returncode != 0
    assert 'embeddings_manifest' in proc.stderr


def test_embed_corpus_cli_end_to_end(env, tmp_path, monkeypatch):
    """The whole CLI loop with no Python API: tools/embed_corpus.py ->
    tools/score_embeddings.py reproduces analyze() byte-for-byte, and a
    rerun of the embed tool resumes (skips everything)."""

    monkeypatch.setattr(cfg, 'DIR_MODELS', env['models'])
    monkeypatch.setenv('BUZZDETECT_DIR_MODELS', env['models'])

    golden = tmp_path / 'golden'
    analyze(modelname='scoremodel', dir_audio=env['audio'],
            dir_out=str(golden), verbosity_print='ERROR')

    emb = tmp_path / 'emb'

    def _embed(args):
        return subprocess.run(
            [sys.executable] + TOOL_EMBED + args, capture_output=True,
            text=True, timeout=300, env=dict(os.environ), cwd=REPO)

    proc = _embed(['--dir_audio', env['audio'], '--dir_out', str(emb),
                   '--modelname', 'scoremodel'])
    assert proc.returncode == 0, proc.stderr
    assert 'embedded 2 new file(s)' in proc.stdout

    proc = _embed(['--dir_audio', env['audio'], '--dir_out', str(emb),
                   '--modelname', 'scoremodel'])
    assert proc.returncode == 0, proc.stderr
    assert 'embedded 0 new file(s)' in proc.stdout  # resumed

    # a settings conflict fails loudly with a clean error, not a traceback
    proc = _embed(['--dir_audio', env['audio'], '--dir_out', str(emb),
                   '--modelname', 'scoremodel', '--framehop', '0.5'])
    assert proc.returncode != 0
    assert 'conflicts' in proc.stderr and 'Traceback' not in proc.stderr

    out = tmp_path / 'rescored'
    proc = _run_tool(['--dir_embeddings', str(emb),
                      '--modelname', 'scoremodel', '--dir_out', str(out)])
    assert proc.returncode == 0, proc.stderr
    for rel in ('a', 'sub/b'):
        g = (golden / (rel + cfg.SUFFIX_RESULT_COMPLETE)).read_bytes()
        s = (out / (rel + cfg.SUFFIX_RESULT_COMPLETE)).read_bytes()
        assert s == g, f'{rel}: CLI-loop CSV differs from analyze()'


def test_score_embeddings_with_ensemble(env, tmp_path, monkeypatch):
    """Ensemble bundles share the linear-head format, so 'embed once,
    iterate heads' extends to 'score every member in one rescoring pass':
    ensemble columns equal each member's own rescoring."""
    import shutil

    from buzzdetect_torch.models.convert import (build_model_bundle,
                                                 build_ensemble_bundle)

    dir_models = tmp_path / 'models'
    dir_models.mkdir()
    # second member shares the scoremodel's embedder weights (same seed
    # path: copy the bundle and retrain nothing — ensemble requires
    # identical embedders), different head via a different class list
    shutil.copytree(os.path.join(env['models'], 'scoremodel'),
                    dir_models / 'm_a')
    shutil.copytree(os.path.join(env['models'], 'scoremodel'),
                    dir_models / 'm_b')
    build_ensemble_bundle([str(dir_models / 'm_a'), str(dir_models / 'm_b')],
                          str(dir_models / 'duo'))
    monkeypatch.setattr(cfg, 'DIR_MODELS', str(dir_models))
    monkeypatch.setenv('BUZZDETECT_DIR_MODELS', str(dir_models))

    emb = tmp_path / 'emb'
    embed_directory(env['audio'], str(emb), modelname='m_a',
                    log=lambda *a: None)

    out_duo = tmp_path / 'duo_scores'
    proc = _run_tool(['--dir_embeddings', str(emb), '--modelname', 'duo',
                      '--dir_out', str(out_duo)])
    assert proc.returncode == 0, proc.stderr
    header = open(out_duo / ('a' + cfg.SUFFIX_RESULT_COMPLETE)).readline()
    cols = header.strip().split(',')
    assert cols[0] == 'start'
    assert f'activation_m_a.{CLASSES[0]}' in cols
    assert f'activation_m_b.{CLASSES[0]}' in cols

    # member columns match the member's own rescoring exactly
    out_a = tmp_path / 'a_scores'
    proc = _run_tool(['--dir_embeddings', str(emb), '--modelname', 'm_a',
                      '--dir_out', str(out_a)])
    assert proc.returncode == 0, proc.stderr
    rows_duo = open(out_duo / ('a' + cfg.SUFFIX_RESULT_COMPLETE)
                    ).read().splitlines()
    rows_a = open(out_a / ('a' + cfg.SUFFIX_RESULT_COMPLETE)
                  ).read().splitlines()
    i_duo = cols.index(f'activation_m_a.{CLASSES[1]}')
    i_a = rows_a[0].split(',').index(f'activation_{CLASSES[1]}')
    for r_duo, r_a in zip(rows_duo[1:], rows_a[1:]):
        assert r_duo.split(',')[i_duo] == r_a.split(',')[i_a]


def test_embed_chunk_boundaries_match_streamer(env, tmp_path, monkeypatch):
    """Multi-chunk embedding must read EXACTLY the streamer's sample
    spans: int(t1*rate)-int(t0*rate) and int((t1-t0)*rate) disagree by
    one sample on non-frame-aligned final chunks (5 s at chunklength 2.0
    -> final chunk (3.84, 5.0): 18560 vs 18559 samples), which embeds one
    zero-padded sample where analyze() saw real audio and breaks the
    byte-parity contract on any recording longer than one chunk."""

    monkeypatch.setattr(cfg, 'DIR_MODELS', env['models'])
    monkeypatch.setenv('BUZZDETECT_DIR_MODELS', env['models'])

    dir_audio = tmp_path / 'audio'
    dir_audio.mkdir()
    # NOT a tone: a frame scored over near-constant audio rounds to the
    # same 2 decimals with or without the missing sample — broadband
    # noise makes the one-sample pad visible in the raw scores
    rng = np.random.default_rng(5)
    write_wav(dir_audio / 'long.wav',
              (rng.standard_normal(5 * 16000) * 0.2).astype(np.float32),
              16000)

    golden = tmp_path / 'golden'
    analyze(modelname='scoremodel', dir_audio=str(dir_audio),
            dir_out=str(golden), verbosity_print='ERROR')

    emb = tmp_path / 'emb'
    embed_directory(str(dir_audio), str(emb), modelname='scoremodel',
                    chunklength=2.0, log=lambda *_: None)
    out = tmp_path / 'rescored'
    proc = subprocess.run(
        [sys.executable] + TOOL + ['--dir_embeddings', str(emb),
                                   '--modelname', 'scoremodel',
                                   '--dir_out', str(out)],
        capture_output=True, text=True, timeout=300, env=dict(os.environ),
        cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    g = (golden / ('long' + cfg.SUFFIX_RESULT_COMPLETE)).read_bytes()
    s = (out / ('long' + cfg.SUFFIX_RESULT_COMPLETE)).read_bytes()
    assert s == g, 'multi-chunk embed drifted from analyze()'
    _vs_jax(env['models'], dir_audio, out, ('long',), tmp_path)
