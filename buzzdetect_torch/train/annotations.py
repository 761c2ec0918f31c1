"""Event annotations -> per-frame training labels.

Field annotations arrive as labeled time spans (ident, start, end, label).
A frame gets a label when it overlaps the event by at least
``overlap_prop`` of the frame length — the reference's training recipe
records ``event_overlap_prop: 0.2`` (`models/model_general_v3/config_set.txt`).

Copy of ``buzzdetect_tpu/train/annotations.py``.
"""

import csv
from collections import defaultdict

import numpy as np


def load_events(path_csv: str):
    """Annotation CSV -> {ident: [(start, end, label), ...]}.

    Expected columns (case-insensitive, extras ignored): ident/file, start,
    end, label/class.
    """
    events = defaultdict(list)
    with open(path_csv, newline='') as f:
        reader = csv.DictReader(f)
        cols = {c.lower(): c for c in reader.fieldnames or []}
        c_ident = cols.get('ident') or cols.get('file') or cols.get('path')
        c_start = cols.get('start')
        c_end = cols.get('end')
        c_label = cols.get('label') or cols.get('class')
        if not all((c_ident, c_start, c_end, c_label)):
            raise ValueError(
                f'annotation CSV needs ident/start/end/label columns, got '
                f'{reader.fieldnames}')
        for row in reader:
            events[row[c_ident]].append(
                (float(row[c_start]), float(row[c_end]), row[c_label].strip()))
    return dict(events)


def frames_to_labels(frame_starts, events, classes, *,
                     framelength: float = 0.96,
                     overlap_prop: float = 0.2,
                     translation: dict = None):
    """Frame-start grid + event list -> (n_frames, n_classes) multi-hot.

    A frame [t, t+framelength) is positive for a class when some event of
    that class overlaps it by >= overlap_prop * framelength.
    """
    frame_starts = np.asarray(frame_starts, np.float64)
    index = {c: i for i, c in enumerate(classes)}
    labels = np.zeros((len(frame_starts), len(classes)), np.float32)
    min_overlap = overlap_prop * framelength

    for ev_start, ev_end, raw in events:
        cls = translation.get(raw, raw) if translation else raw
        if cls is None or cls not in index:
            continue
        overlap = (np.minimum(frame_starts + framelength, ev_end)
                   - np.maximum(frame_starts, ev_start))
        labels[overlap >= min_overlap, index[cls]] = 1.0
    return labels
