"""Precision -> activation-threshold calibration.

Parity with reference `src/write/thresholds.py:29-41`: pick the mean threshold
of all rows in the model's evaluation metrics whose precision lies within
± tolerance/2 of the requested precision. The metrics table itself is produced
by the evaluation harness (`buzzdetect_torch.train.evaluate`) — a capability the
reference ships only as a data artifact.

Copy of ``buzzdetect_tpu/write/thresholds.py``, the import prefix and the
evaluation module it names changed.
"""

import os

import numpy as np

from buzzdetect_torch import config as cfg


def load_metrics(modelname: str):
    """Load the (threshold, precision, sensitivity, fpr) table for a model.

    Looks for ``tests/metrics.csv`` in the model directory, falling back to a
    ``metrics`` array packed inside the model's artifact bundle (``model.npz``).
    Returns a dict of 1-D float arrays.
    """
    dir_model = os.path.join(cfg.resolve_dir(cfg.DIR_MODELS), modelname)
    path_csv = os.path.join(dir_model, cfg.SUBDIR_TESTS, cfg.FNAME_METRICS)
    if os.path.exists(path_csv):
        data = np.genfromtxt(path_csv, delimiter=',', names=True)
        # a single-row CSV parses as a 0-d structured scalar; every
        # consumer expects 1-D columns
        return {name: np.atleast_1d(np.asarray(data[name], dtype=np.float64))
                for name in data.dtype.names}

    path_npz = os.path.join(dir_model, 'model.npz')
    if os.path.exists(path_npz):
        with np.load(path_npz) as z:
            if 'metrics_threshold' in z:
                # atleast_1d: bundles built before metrics_from_csv guarded
                # single-row tables may carry 0-d arrays
                return {
                    'threshold': np.atleast_1d(
                        z['metrics_threshold'].astype(np.float64)),
                    'precision': np.atleast_1d(
                        z['metrics_precision'].astype(np.float64)),
                    'sensitivity': np.atleast_1d(
                        z['metrics_sensitivity'].astype(np.float64)),
                    'fpr': np.atleast_1d(
                        z['metrics_fpr'].astype(np.float64)),
                }
    raise FileNotFoundError(
        f'metrics not available for model "{modelname}"; run '
        f'buzzdetect_torch.train.evaluate on a labeled test set to generate them')


def _bracket(metrics: dict, precision_requested: float):
    """The nearest metrics rows strictly above and below the requested
    precision: (idx_over, idx_under), either of which may be None."""
    delta = metrics['precision'] - precision_requested
    over = np.where(delta > 0)[0]
    under = np.where(delta < 0)[0]
    idx_over = over[np.argmin(delta[over])] if over.size else None
    idx_under = under[np.argmax(delta[under])] if under.size else None
    return idx_over, idx_under


def calculate_threshold(modelname: str, precision_requested: float,
                        tolerance: float = 0.01) -> float:
    """Mean threshold over metrics rows with |precision - requested| <=
    tolerance/2; when no row lands inside the tolerance band but rows exist
    on BOTH sides, fall back to the bracketing midpoint (the reference's
    `sx` interpolation, `src/write/thresholds.py:9-22`). A precision outside
    the table's range still raises — extrapolating a calibration would
    silently promise a precision the model was never measured at."""
    metrics = load_metrics(modelname)
    if metrics['precision'].size == 0:
        # a header-only metrics.csv (evaluation produced no usable rows):
        # without this the error path below crashes on .min() of an empty
        # array, masking the real diagnostic
        raise ValueError(f'metrics table for "{modelname}" has no rows; '
                         f're-run evaluation before calibrating thresholds')
    delta = np.abs(metrics['precision'] - precision_requested)
    mask = delta <= tolerance / 2
    if mask.any():
        return float(metrics['threshold'][mask].mean())
    idx_over, idx_under = _bracket(metrics, precision_requested)
    if idx_over is not None and idx_under is not None:
        t_over = metrics['threshold'][idx_over]
        t_under = metrics['threshold'][idx_under]
        return float(t_over + (t_under - t_over) / 2)
    raise ValueError(
        f'no metrics rows within ±{tolerance / 2} of precision '
        f'{precision_requested}; available precision range is '
        f'[{metrics["precision"].min():.3f}, {metrics["precision"].max():.3f}]')


def threshold_at_recall(modelname: str, recall_requested: float) -> dict:
    """Most precise operating point that still catches the requested
    fraction of true events: the HIGHEST threshold whose measured
    sensitivity (recall) meets ``recall_requested``.

    The precision calibrations above answer "how clean must the
    detections be"; abundance surveys need the dual — "miss at most X%
    of buzzes" (undercounting visits is worse than reviewing extra
    clips). Sensitivity is monotone non-increasing in threshold up to
    evaluation noise, so the best qualifying point is simply the largest
    qualifying threshold. Deliberately no interpolation between rows: a
    recall between measured rows is not guaranteed attainable, and
    promising an unmeasured recall would be the same lie the precision
    path refuses to tell (see calculate_threshold).

    Returns ``{'threshold', 'sensitivity', 'precision'}`` — the chosen
    row, unrounded (callers round for display). Raises when no measured
    row reaches the requested recall. Superset capability: the reference
    calibrates precision only (`src/write/thresholds.py:29-41`).
    """
    if not 0.0 < recall_requested <= 1.0:
        raise ValueError(f'recall must be in (0, 1], got {recall_requested}')
    metrics = load_metrics(modelname)
    if metrics['sensitivity'].size == 0:
        raise ValueError(f'metrics table for "{modelname}" has no rows; '
                         f're-run evaluation before calibrating thresholds')
    ok = np.flatnonzero(metrics['sensitivity'] >= recall_requested)
    if ok.size == 0:
        raise ValueError(
            f'no measured operating point reaches recall '
            f'{recall_requested}; the highest measured sensitivity for '
            f'"{modelname}" is {metrics["sensitivity"].max():.3f}')
    i = ok[np.argmax(metrics['threshold'][ok])]
    return {'threshold': float(metrics['threshold'][i]),
            'sensitivity': float(metrics['sensitivity'][i]),
            'precision': float(metrics['precision'][i])}


def threshold_at_precision(modelname: str, precision_requested: float) -> dict:
    """Bracketing threshold lookup (the reference's `sx`,
    `src/write/thresholds.py:9-26`): midpoint of the nearest thresholds
    above/below the requested precision, clamped to the edge row when the
    request falls past one end of the table.

    Returns ``{'threshold', 'precision', 'sensitivity'}`` rounded to 2
    digits like the reference. Sensitivity comes from the metrics table
    (mean of the bracket rows) rather than a per-sample re-count — the
    table is what the bundle ships."""
    metrics = load_metrics(modelname)
    # an exact-precision row is the measured answer — bracketing around it
    # would average in its neighbors (or, for a one-row table, find nothing)
    exact = np.where(metrics['precision'] == precision_requested)[0]
    if exact.size:
        return {'threshold': round(float(
                    metrics['threshold'][exact].mean()), 2),
                'precision': round(float(precision_requested), 2),
                'sensitivity': round(float(
                    metrics['sensitivity'][exact].mean()), 2)}
    idx_over, idx_under = _bracket(metrics, precision_requested)
    if idx_over is None and idx_under is None:
        raise ValueError(f'empty metrics table for "{modelname}"')
    if idx_over is None:
        # request falls past the table's top: report the edge row's ACTUAL
        # measured precision, not the requested value — labeling the edge
        # threshold with an unmeasured precision promises calibration the
        # model never achieved
        threshold = metrics['threshold'][idx_under]
        sens = metrics['sensitivity'][idx_under]
        achieved = metrics['precision'][idx_under]
    elif idx_under is None:
        threshold = metrics['threshold'][idx_over]
        sens = metrics['sensitivity'][idx_over]
        achieved = metrics['precision'][idx_over]
    else:
        t_over = metrics['threshold'][idx_over]
        t_under = metrics['threshold'][idx_under]
        threshold = t_over + (t_under - t_over) / 2
        sens = (metrics['sensitivity'][idx_over]
                + metrics['sensitivity'][idx_under]) / 2
        achieved = precision_requested
    return {'threshold': round(float(threshold), 2),
            'precision': round(float(achieved), 2),
            'sensitivity': round(float(sens), 2)}
