"""tests/test_report.py, case for case, against ``buzzdetect_torch`` (import
prefix changed, same assertions). No edit beyond the import prefix.

The JAX package's docstring:

Model-card report artifacts (train/report.py): the plot/history set the
reference ships per model (reference models/model_general_v3/loss_curves.svg,
history.pickle, tests/*.svg).
"""

import json
import os

import numpy as np
import pytest

pytest.importorskip('matplotlib')

from buzzdetect_torch.train import report  # noqa: E402
from buzzdetect_torch.train.evaluate import threshold_sweep  # noqa: E402


def _svg_ok(path):
    assert os.path.exists(path), path
    with open(path) as f:
        head = f.read(4096)
    assert '<svg' in head, path
    return True


def _eval_set(n=400, seed=0):
    """Separable synthetic eval set: buzz frames score high."""
    rng = np.random.default_rng(seed)
    classes = ['ins_buzz', 'ambient_background', 'mech_plane']
    labels = np.zeros((n, 3), bool)
    labels[:n // 4, 0] = True
    labels[n // 4:n // 2, 1] = True
    labels[n // 2:3 * n // 4, 2] = True
    # last quarter stays unlabeled
    scores = rng.normal(-2.0, 1.0, n)
    scores[labels[:, 0]] += 3.5
    return scores, labels, classes


def test_history_roundtrip(tmp_path):
    path = report.save_history(str(tmp_path / 'history.json'),
                               {'loss': [1.0, 0.5, 0.25]})
    back = report.load_history(path)
    assert list(back) == ['loss']
    np.testing.assert_allclose(back['loss'], [1.0, 0.5, 0.25])
    # plain JSON on disk, not a pickle
    with open(path) as f:
        assert json.load(f) == {'loss': [1.0, 0.5, 0.25]}


def test_detection_outcomes_counts():
    scores = np.array([1.0, 1.0, -1.0, -1.0, 1.0, -1.0])
    labels = np.array([[1, 0], [1, 0], [1, 0], [0, 1], [0, 1], [0, 0]],
                      dtype=bool)
    out = report.detection_outcomes(scores, labels, ['ins_buzz', 'bg'],
                                    'ins_buzz', threshold=0.0)
    assert out['ins_buzz'] == {'true positive': 2, 'false positive': 0,
                               'true negative': 0, 'false negative': 1}
    assert out['bg'] == {'true positive': 0, 'false positive': 1,
                         'true negative': 1, 'false negative': 0}
    # the unlabeled frame tallies under its own row
    assert out['(unlabeled)']['true negative'] == 1
    # ordered by total frames: ins_buzz (3) first
    assert list(out)[0] == 'ins_buzz'


def test_operating_point_picks_lowest_qualifying_threshold():
    metrics = {'threshold': np.array([0.0, 1.0, 2.0]),
               'precision': np.array([0.5, 0.92, 0.99]),
               'sensitivity': np.array([0.9, 0.6, 0.3])}
    thr, prec, sens = report._operating_point(metrics, 0.9)
    assert (thr, prec, sens) == (1.0, 0.92, 0.6)
    # target above the table: fall back to the most precise row
    thr, prec, _ = report._operating_point(metrics, 0.999)
    assert (thr, prec) == (2.0, 0.99)


def test_write_model_report_full_set(tmp_path):
    scores, labels, classes = _eval_set()
    metrics = threshold_sweep(scores, labels[:, 0])
    buzz = labels[:, 0]
    half = np.zeros_like(buzz)
    half[:len(half) // 8] = True
    groups = {'low': buzz & half, 'high': buzz & ~half}
    written = report.write_model_report(
        str(tmp_path), history={'loss': [1.0, 0.4, 0.2]}, metrics=metrics,
        scores=scores, labels=labels, classes=classes, groups=groups)
    names = {os.path.relpath(p, tmp_path) for p in written}
    assert names == {
        'history.json', 'loss_curves.svg', 'tests/metrics.svg',
        'tests/activation_overall.svg', 'tests/positives.svg',
        'tests/activation_groups.svg', 'tests/metrics_ins_buzz.svg'}
    for p in written:
        if p.endswith('.svg'):
            _svg_ok(p)


def test_write_model_report_partial_inputs(tmp_path):
    # history only: no tests/ artifacts, no crash on missing metrics
    written = report.write_model_report(str(tmp_path),
                                        history=[1.0, 0.5])
    assert {os.path.basename(p) for p in written} == {'history.json',
                                                      'loss_curves.svg'}
    # scores without metrics: operating point falls back to threshold 0
    scores, labels, classes = _eval_set(seed=1)
    written = report.write_model_report(
        str(tmp_path), scores=scores, labels=labels, classes=classes)
    assert any(p.endswith('positives.svg') for p in written)


def test_one_sided_group_is_skipped(tmp_path):
    scores, labels, classes = _eval_set(seed=2)
    # a group mask with no positive frames can't sweep; report must not die
    groups = {'empty': np.zeros(len(scores), bool)}
    written = report.write_model_report(
        str(tmp_path), metrics=threshold_sweep(scores, labels[:, 0]),
        scores=scores, labels=labels, classes=classes, groups=groups)
    assert not any(p.endswith('metrics_ins_buzz.svg') for p in written)
    assert not any(p.endswith('activation_groups.svg') for p in written)
