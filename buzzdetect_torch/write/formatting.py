"""Result formatting: model activations -> result-CSV rows.

Output schema parity with reference `src/write/formatting.py:5-49`:

* activations mode: columns ``start, activation_<class>...``, activations rounded
  to ``digits_results``, optional class subset;
* detections mode: columns ``start, detections_ins_buzz`` with 0/1 thresholded
  on the ``ins_buzz`` activation;
* ``start`` = ``row_index * framehop_s + time_start``, rounded to ``digits_time``.

Implemented on numpy + a tiny CSV renderer (no pandas in the hot write path).
"""

import numpy as np

from buzzdetect_torch import config as cfg


class ResultTable:
    """A small column table destined for CSV."""

    __slots__ = ('columns', 'start', 'values')

    def __init__(self, columns, start, values):
        self.columns = columns          # list[str], excludes 'start'
        self.start = start              # (n,) float array
        self.values = values            # (n, len(columns)) array

    def __len__(self):
        return len(self.start)

    def header(self) -> str:
        return ','.join(['start'] + self.columns)

    def render_csv(self, digits_time: int, include_header: bool) -> str:
        """Render to CSV text. Floats print like Python/pandas repr of the
        rounded value (no trailing-zero padding)."""
        lines = []
        if include_header:
            lines.append(self.header())
        is_int = np.issubdtype(self.values.dtype, np.integer)
        for t, row in zip(self.start, self.values):
            cells = [repr(round(float(t), digits_time))]
            if is_int:
                cells.extend(str(int(v)) for v in row)
            else:
                cells.extend(repr(float(v)) for v in row)
            lines.append(','.join(cells))
        # an empty headerless render must append nothing, not a blank line
        return '\n'.join(lines) + '\n' if lines else ''


def add_time(n_rows: int, time_start: float, framehop_s: float, digits_time: int):
    """Frame start timestamps for ``n_rows`` consecutive frames."""
    starts = np.arange(n_rows, dtype=np.float64) * framehop_s
    if time_start != 0:
        starts = starts + time_start
    return np.round(starts, digits_time)


def format_activations(results, classes, framehop_s, digits_time, time_start=0.0,
                       classes_keep='all', digits_results=2) -> ResultTable:
    """Per-frame raw activations, optionally subset to ``classes_keep``."""
    results = np.round(np.asarray(results, dtype=np.float64), digits_results)

    if classes_keep == 'all':
        classes_out = list(classes)
    else:
        unknown = set(classes_keep) - set(classes)
        if unknown:
            raise ValueError(
                f"Bad classes in classes_keep: {', '.join(sorted(unknown))}")
        keep = [i for i, c in enumerate(classes) if c in classes_keep]
        results = results[:, keep]
        classes_out = [classes[i] for i in keep]

    start = add_time(len(results), time_start, framehop_s, digits_time)
    columns = [cfg.PREFIX_COLUMN_ACTIVATION + c for c in classes_out]
    return ResultTable(columns, start, results)


def result_header(classes, classes_keep='all', threshold=None) -> str:
    """The exact header line this run's writer will produce.

    The schema pin for resume readers: a partial whose header differs was
    written under different settings (mode/classes), so its rows must NOT
    count as coverage — the writer quarantines such a partial on first
    append, and a streamer that had already counted its rows would then
    finalize a complete file missing those spans forever.
    """
    empty = np.zeros((0, len(classes)))
    if threshold is None:
        table = format_activations(empty, classes, framehop_s=0.0,
                                   digits_time=2, classes_keep=classes_keep)
    else:
        table = format_detections(empty, threshold, classes, framehop_s=0.0,
                                  digits_time=2)
    return table.header()


def format_detections(results, threshold, classes, framehop_s, digits_time,
                      time_start=0.0) -> ResultTable:
    """Binary buzz detections: ``ins_buzz`` activation > threshold."""
    results = np.asarray(results)
    buzz_index = list(classes).index('ins_buzz')
    detections = (results[:, buzz_index] > threshold).astype(np.int64)
    start = add_time(len(detections), time_start, framehop_s, digits_time)
    return ResultTable([cfg.PREFIX_COLUMN_DETECTION + 'ins_buzz'],
                       start, detections[:, None])
