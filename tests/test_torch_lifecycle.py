"""tests/test_lifecycle.py, case for case, against ``buzzdetect_torch`` (import
prefix changed, same assertions). Edits: training runs ``python -m
buzzdetect_torch.tools.train_model --device cpu`` (the JAX case runs the
JAX package's ``tools/train_model.py``), and the trained detector runs
through the port's ``analyze()`` on ``device='cpu'`` (the module's
``analyze`` wrapper). The JAX case is marked ``slow``; this one is not, so
the tier-1 run counts it.

The JAX package's docstring:

Semantic lifecycle test: train a detector from labeled audio, calibrate a
threshold from its OWN evaluation metrics, and verify it actually detects.

This closes the loop the reference ecosystem implies but never ships
(`src/write/thresholds.py:35` references a missing `test_model` function):
corpus embedding -> event labeling -> head training -> holdout threshold
sweep -> bundle with packed metrics -> detections-mode analysis at a
requested precision. It also demonstrates that the framework trains WORKING
detectors even without the unobtainable pretrained yamnet.h5 — a seeded
random CNN is still a usable feature extractor for separable sounds.
"""

import csv
import os
import subprocess
import sys

import numpy as np
import pytest

from buzzdetect_torch import config as cfg
from buzzdetect_torch.models.convert import build_model_bundle
from tests.audio_fixtures import make_tone, write_wav


def analyze(**kw):
    """The port's analyze(), on the CPU unless the case names a device."""
    from buzzdetect_torch import analysis
    kw.setdefault('device', 'cpu')
    return analysis.analyze(**kw)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(42)


def _noise(seconds, scale=0.1):
    return (RNG.standard_normal(int(seconds * 16000)) * scale
            ).astype(np.float32)


def test_train_calibrate_detect(tmp_path, monkeypatch):
    dir_models = tmp_path / 'models'
    build_model_bundle(str(dir_models / 'base'), classes=['x'], seed=2)

    # labeled training corpus: buzzy tones vs ambient noise
    dir_corpus = tmp_path / 'corpus'
    dir_corpus.mkdir()
    ann_lines = ['ident,start,end,label']
    for i in range(8):
        write_wav(dir_corpus / f'buzz{i}.wav',
                  make_tone(4.0, 16000, 200 + 10 * i) + _noise(4.0, 0.02),
                  16000)
        ann_lines.append(f'buzz{i},0,4,ins_buzz')
    for i in range(8):
        write_wav(dir_corpus / f'amb{i}.wav', _noise(4.0), 16000)
    ann = tmp_path / 'events.csv'
    ann.write_text('\n'.join(ann_lines) + '\n')

    env = dict(os.environ, BUZZDETECT_DIR_MODELS=str(dir_models))
    ret = subprocess.run(
        [sys.executable, '-m', 'buzzdetect_torch.tools.train_model',
         '--name', 'fielddet',
         '--dir-audio', str(dir_corpus), '--annotations', str(ann),
         '--classes', 'ins_buzz', 'ambient_background',
         '--base-model', 'base', '--epochs', '400',
         '--learning-rate', '0.01', '--holdout', '0.4', '--device', 'cpu'],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert ret.returncode == 0, ret.stdout + ret.stderr
    assert 'threshold rows' in ret.stdout  # holdout evaluation ran

    # the bundle ships its model card (reference models/<name>/tests/)
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        matplotlib = None
    if matplotlib is not None:
        dir_model = dir_models / 'fielddet'
        for rel in ('history.json', 'loss_curves.svg', 'tests/metrics.svg',
                    'tests/activation_overall.svg', 'tests/positives.svg'):
            assert (dir_model / rel).exists(), f'missing model-card {rel}'

    # fresh, unseen test recordings
    dir_test = tmp_path / 'field'
    dir_test.mkdir()
    write_wav(dir_test / 'has_buzz.wav',
              make_tone(4.0, 16000, 231) + _noise(4.0, 0.02), 16000)
    write_wav(dir_test / 'no_buzz.wav', _noise(4.0), 16000)

    # detections mode: threshold calibrated from the model's OWN metrics
    monkeypatch.setattr(cfg, 'DIR_MODELS', str(dir_models))
    dir_out = str(tmp_path / 'out')
    analyze(modelname='fielddet', dir_audio=str(dir_test), dir_out=dir_out,
            chunklength=2.0, precision=0.9, verbosity_print='ERROR')

    def detections(path):
        with open(path) as f:
            rows = list(csv.reader(f))
        assert rows[0] == ['start', 'detections_ins_buzz']
        return [int(r[1]) for r in rows[1:]]

    hits = detections(os.path.join(dir_out, 'has_buzz_buzzdetect.csv'))
    misses = detections(os.path.join(dir_out, 'no_buzz_buzzdetect.csv'))
    assert sum(hits) >= len(hits) * 0.75, \
        f'trained detector missed the buzz: {hits}'
    assert sum(misses) == 0, f'false positives on pure noise: {misses}'
