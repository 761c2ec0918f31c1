"""Training-data utilities: label translation and class weighting.

Mirrors the data artifacts the reference's (unshipped) training harness
consumed: ``translation.csv`` maps raw annotation labels to training classes
(reference `models/model_general_v3/translation.csv`), and ``weights.csv``
records per-class frame counts and loss weights
(`models/model_general_v3/weights.csv`).

Copy of ``buzzdetect_tpu/train/data.py``.
"""

import csv

import numpy as np


def load_translation(path_csv: str) -> dict:
    """raw label -> training class (or None to drop). Accepts a CSV with the
    raw label in the first column and the target class in the second;
    empty/'drop' targets mean the label is excluded."""
    mapping = {}
    with open(path_csv, newline='') as f:
        reader = csv.reader(f)
        first = next(reader, None)
        if first is None:
            raise ValueError(f'empty translation file: {path_csv}')
        # a header row is optional (the reference's translation.csv has
        # one); detect it by its conventional column names rather than
        # silently discarding a headerless file's first mapping
        looks_like_header = (first[0].strip().lower()
                             in ('raw', 'label', 'from', 'annotation'))
        rows = reader if looks_like_header else [first] + list(reader)
        for row in rows:
            if not row or not row[0]:
                continue
            target = row[1].strip() if len(row) > 1 else ''
            mapping[row[0].strip()] = target if target and target.lower() \
                not in ('drop', 'none', 'na') else None
    return mapping


def translate_labels(raw_labels, translation: dict, classes) -> np.ndarray:
    """List of per-clip raw-label lists -> (N, C) multi-hot matrix.

    Unknown or dropped labels are ignored.
    """
    index = {c: i for i, c in enumerate(classes)}
    out = np.zeros((len(raw_labels), len(classes)), np.float32)
    for i, labels in enumerate(raw_labels):
        for raw in labels:
            cls = translation.get(raw, raw)
            if cls is not None and cls in index:
                out[i, index[cls]] = 1.0
    return out


def load_class_weights(path_csv: str, classes) -> np.ndarray:
    """Per-class loss weights from a weights.csv (columns including a class
    name and a weight). Missing classes weight 1.0."""
    weights = {c: 1.0 for c in classes}
    with open(path_csv, newline='') as f:
        reader = csv.DictReader(f)
        name_col = None
        weight_col = None
        for field in reader.fieldnames or []:
            low = field.lower()
            if name_col is None and low in ('class', 'classes', 'name', ''):
                name_col = field
            if weight_col is None and 'weight' in low:
                weight_col = field
        if name_col is None:
            name_col = (reader.fieldnames or [''])[0]
        for row in reader:
            cls = (row.get(name_col) or '').strip()
            if cls in weights and weight_col and row.get(weight_col):
                weights[cls] = float(row[weight_col])
    return np.array([weights[c] for c in classes], np.float32)


def class_weights_from_counts(counts) -> np.ndarray:
    """Inverse-frequency weights normalized to mean 1 (the usual recipe when
    only per-class frame counts are available)."""
    counts = np.asarray(counts, np.float64)
    w = counts.sum() / np.maximum(counts, 1) / len(counts)
    return (w / w.mean()).astype(np.float32)
