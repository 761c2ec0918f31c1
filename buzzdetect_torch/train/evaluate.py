"""Model evaluation: threshold sweep -> precision/sensitivity/FPR table.

This regenerates the artifact the reference treats as load-bearing data
(`models/<name>/tests/metrics.csv`, 578 rows driving runtime threshold
calibration at `src/write/thresholds.py:29-41`) but whose producing harness
(`test_model(...)`) is absent from the reference tree.

Copy of ``buzzdetect_tpu/train/evaluate.py``; ``evaluate_model_on_clips``
brings the port classifier's device tensors to the host (``_host``) before
taking each clip's maximum.
"""

import os

import numpy as np
import torch


def _host(x):
    """A classifier's output (a device tensor, or an array from a duck-typed
    classifier) as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def threshold_sweep(scores, labels, thresholds=None):
    """Per-threshold detection metrics for one class.

    ``scores``: (N,) raw activations for the target class;
    ``labels``: (N,) boolean/0-1 ground truth for that class.
    Returns dict of arrays: threshold, precision, sensitivity, fpr.
    Thresholds with no predicted positives are dropped (precision undefined),
    matching the reference table's shape.
    """
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels).astype(bool)
    if thresholds is None:
        thresholds = np.unique(np.round(scores, 2))

    rows = {'threshold': [], 'precision': [], 'sensitivity': [], 'fpr': []}
    n_pos = int(labels.sum())
    n_neg = int((~labels).sum())
    if n_pos == 0 or n_neg == 0:
        # a one-sided eval set cannot calibrate anything: silently clamping
        # would bake an all-zero sensitivity (or fpr) column into the bundle
        # and later drive precision->threshold calibration off nonsense
        raise ValueError(
            f'evaluation set is one-sided ({n_pos} positive / {n_neg} '
            f'negative frames); a threshold sweep needs both classes — '
            f'grow or rebalance the holdout split')
    for t in np.sort(thresholds):
        pred = scores > t
        tp = int((pred & labels).sum())
        fp = int((pred & ~labels).sum())
        if tp + fp == 0:
            continue
        rows['threshold'].append(float(t))
        rows['precision'].append(tp / (tp + fp))
        rows['sensitivity'].append(tp / n_pos)
        rows['fpr'].append(fp / n_neg)
    return {k: np.asarray(v) for k, v in rows.items()}


def evaluate_scores(scores, labels, classes, target_class='ins_buzz'):
    """Multi-class activations (N, C) + multi-hot labels -> sweep for the
    detection class."""
    ci = list(classes).index(target_class)
    return threshold_sweep(scores[:, ci], labels[:, ci])


def write_metrics_csv(path, metrics):
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    keys = ['threshold', 'precision', 'sensitivity', 'fpr']
    with open(path, 'w') as f:
        f.write(','.join(f'"{k}"' for k in keys) + '\n')
        for i in range(len(metrics['threshold'])):
            f.write(','.join(repr(round(float(metrics[k][i]), 10))
                             for k in keys) + '\n')
    return path


def evaluate_model_on_clips(classifier, clips, labels, classes,
                            target_class='ins_buzz'):
    """Score labeled clips with a ChunkClassifier and sweep thresholds.

    ``clips``: iterable of 16 kHz mono waveforms; ``labels``: (N, C) multi-hot.
    Each clip contributes its max per-class activation (clip-level decision).

    Clips dispatch asynchronously (and same-length runs batch into single
    device calls) — a blocking predict per clip would make large eval sets
    dispatch-latency-bound for no reason.
    """
    clips = list(clips)
    if not clips:
        # fail with a diagnostic instead of np.stack's bare 'need at least
        # one array to stack' (e.g. a holdout split that came out empty)
        raise ValueError('evaluate_model_on_clips got an empty clip list — '
                         'check the train/eval split')
    scores = [None] * len(clips)
    batcher = getattr(classifier, 'predict_async_batch', None)
    i = 0
    while i < len(clips):
        j = i + 1
        if batcher is not None:
            while (j < len(clips) and j - i < 128
                   and len(clips[j]) == len(clips[i])):
                j += 1
        if batcher is not None and j - i > 1:
            out, n_valids = batcher(clips[i:j])
            out = _host(out)
            for k in range(i, j):
                scores[k] = out[k - i][:n_valids[k - i]].max(axis=0)
        else:
            act, n_valid = classifier.predict_async(clips[i])
            scores[i] = _host(act)[:n_valid].max(axis=0)
        i = j
    scores = np.stack(scores)
    return evaluate_scores(scores, np.asarray(labels), classes, target_class)
