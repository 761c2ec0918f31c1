"""tests/test_formatting.py, case for case, against ``buzzdetect_torch``
(import prefix changed, same assertions). No edit beyond the import prefix.

The JAX package's docstring:

Unit tests for result formatting and threshold calibration.
"""

import numpy as np
import pytest

from buzzdetect_torch.write.formatting import format_activations, format_detections

CLASSES = ['mech_train', 'ins_buzz', 'human']


def test_activations_columns_and_rounding():
    results = np.array([[0.123456, -1.23456, 2.0],
                        [0.5, 0.4449, -0.001]])
    t = format_activations(results, CLASSES, framehop_s=0.96, digits_time=2)
    assert t.columns == ['activation_mech_train', 'activation_ins_buzz',
                         'activation_human']
    assert np.allclose(t.values[0], [0.12, -1.23, 2.0])
    assert np.allclose(t.start, [0.0, 0.96])


def test_activations_subset_preserves_model_order():
    results = np.arange(6, dtype=np.float64).reshape(2, 3)
    t = format_activations(results, CLASSES, framehop_s=0.96, digits_time=2,
                           classes_keep=['human', 'ins_buzz'])
    # order follows the model's class order, not the selection order
    assert t.columns == ['activation_ins_buzz', 'activation_human']
    assert np.allclose(t.values, [[1, 2], [4, 5]])


def test_activations_unknown_class_raises():
    with pytest.raises(ValueError, match='nope'):
        format_activations(np.zeros((1, 3)), CLASSES, 0.96, 2,
                           classes_keep=['nope'])


def test_activations_time_offset():
    t = format_activations(np.zeros((3, 3)), CLASSES, framehop_s=0.48,
                           digits_time=2, time_start=100.0)
    assert np.allclose(t.start, [100.0, 100.48, 100.96])


def test_detections_threshold():
    results = np.array([[0.0, -1.5, 0.0],
                        [0.0, -1.0, 0.0],
                        [0.0, 0.5, 0.0]])
    t = format_detections(results, threshold=-1.2, classes=CLASSES,
                          framehop_s=0.96, digits_time=2)
    assert t.columns == ['detections_ins_buzz']
    assert t.values[:, 0].tolist() == [0, 1, 1]


def test_csv_render():
    t = format_activations(np.array([[0.1, -1.234567, 3.0]]), CLASSES,
                           framehop_s=0.96, digits_time=2)
    csv_text = t.render_csv(digits_time=2, include_header=True)
    lines = csv_text.strip().split('\n')
    assert lines[0] == 'start,activation_mech_train,activation_ins_buzz,activation_human'
    assert lines[1] == '0.0,0.1,-1.23,3.0'


def test_threshold_calibration(tmp_path, monkeypatch):
    from buzzdetect_torch import config as cfg
    from buzzdetect_torch.write import thresholds

    d = tmp_path / 'models' / 'm' / 'tests'
    d.mkdir(parents=True)
    rows = ['threshold,precision,sensitivity,fpr']
    # precision climbs with threshold; rows at precision .949, .95, .951
    rows += ['-1.3,0.949,0.3,0.004', '-1.2,0.95,0.28,0.003', '-1.1,0.951,0.25,0.002',
             '-0.5,0.99,0.1,0.0001']
    (d / 'metrics.csv').write_text('\n'.join(rows) + '\n')

    monkeypatch.setattr(cfg, 'DIR_MODELS', str(tmp_path / 'models'))
    thr = thresholds.calculate_threshold('m', 0.95, tolerance=0.01)
    # rows within ±0.005: all three around 0.95 → mean of thresholds
    assert thr == pytest.approx((-1.3 + -1.2 + -1.1) / 3)

    # nothing inside the band but bracketed → interpolating midpoint
    # (requested 0.97 sits between the .951 and .99 rows)
    thr = thresholds.calculate_threshold('m', 0.97, tolerance=0.01)
    assert thr == pytest.approx((-1.1 + -0.5) / 2)

    # outside the measured range still refuses (no extrapolation)
    with pytest.raises(ValueError):
        thresholds.calculate_threshold('m', 0.80, tolerance=0.01)

    # the sx-analog bracketing lookup: midpoint + mean sensitivity
    out = thresholds.threshold_at_precision('m', 0.97)
    assert out == {'threshold': pytest.approx(-0.8), 'precision': 0.97,
                   'sensitivity': round((0.25 + 0.1) / 2, 2)}
    # past the table's ends it clamps to the edge row (reference behavior)
    assert thresholds.threshold_at_precision('m', 0.80)['threshold'] == -1.3
    assert thresholds.threshold_at_precision('m', 0.999)['threshold'] == -0.5

    # a request EXACTLY equal to a measured row returns that row's
    # threshold — bracketing would skip the row and average its neighbors
    out = thresholds.threshold_at_precision('m', 0.99)
    assert out['threshold'] == -0.5
    assert out['sensitivity'] == 0.1


def test_threshold_at_precision_single_exact_row(tmp_path, monkeypatch):
    """A one-row table whose precision equals the request must return that
    row, not raise 'empty metrics table' (the exact row used to fall out of
    both brackets)."""
    from buzzdetect_torch import config as cfg
    from buzzdetect_torch.write import thresholds
    d = tmp_path / 'models' / 'one' / 'tests'
    d.mkdir(parents=True)
    (d / 'metrics.csv').write_text(
        'threshold,precision,sensitivity,fpr\n-1.2,0.95,0.28,0.003\n')
    monkeypatch.setattr(cfg, 'DIR_MODELS', str(tmp_path / 'models'))
    out = thresholds.threshold_at_precision('one', 0.95)
    assert out == {'threshold': -1.2, 'precision': 0.95,
                   'sensitivity': 0.28}


def test_render_read_roundtrip_randomized(tmp_path):
    """The writer's CSV renderer and the resume reader are two halves of one
    contract: every rendered row must read back as a complete row with its
    start time intact, for random shapes, precisions, and class subsets."""
    import numpy as np
    from buzzdetect_torch.write.coverage import read_result_rows
    from buzzdetect_torch.write.formatting import (format_activations,
                                                 format_detections)
    rng = np.random.default_rng(3)
    classes = ['ins_buzz', 'ambient_noise', 'frog']
    for i in range(50):
        n = int(rng.integers(0, 30))
        results = rng.normal(0, 3, (n, len(classes)))
        hop = float(rng.choice([0.96, 0.48, 0.32, 0.1, 1.44]))
        t0 = round(float(rng.uniform(0, 1000)), 2)
        if rng.random() < 0.5:
            keep = list(rng.choice(classes, size=int(rng.integers(1, 4)),
                                   replace=False))
            table = format_activations(results, classes, hop, 2, t0,
                                       classes_keep=keep,
                                       digits_results=int(rng.integers(1, 4)))
        else:
            table = format_detections(results, 0.0, classes, hop, 2, t0)
        path = str(tmp_path / f'r{i}_buzzpart.csv')
        with open(path, 'w') as f:
            f.write(table.render_csv(2, include_header=True))
        header, rows, torn = read_result_rows(path)
        assert torn == []
        assert header is not None and header[0] == 'start'
        assert len(rows) == n
        for j, row in enumerate(rows):
            assert float(row[0]) == round(j * hop + t0, 2)
