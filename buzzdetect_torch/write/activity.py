"""Activity aggregation: called events -> buzz activity over wall-clock time.

The "sounds to stats" end of the workflow (the reference ecosystem points
users at its R companion and a blog walkthrough for this step — reference
`docs/source/index.rst:35`): field studies don't report per-frame
activations, they report *activity* — detected seconds and event counts
per hour or day, across a deployment of recordings. Recorders encode the
wall-clock start in the filename (AudioMoth `20240601_123000.WAV`,
SongMeter `HIVE3_20240601_123000.wav`, ...), so the recording timeline can
be reconstructed from the idents the result files already carry.

Copy of ``buzzdetect_tpu/write/activity.py``, import prefix changed.
"""

import os
from datetime import datetime, timedelta

__all__ = ['parse_ident_timestamp', 'bin_events', 'render_activity_csv']

# AudioMoth / SongMeter style, the de-facto field convention
DEFAULT_TIMESTAMP_FORMAT = '%Y%m%d_%H%M%S'


def parse_ident_timestamp(ident: str,
                          fmt: str = DEFAULT_TIMESTAMP_FORMAT):
    """Recover a recording's wall-clock start from its ident, or None.

    Recorder naming conventions embed a FIXED-WIDTH timestamp somewhere in
    the basename (often after a station prefix: ``HIVE3_20240601_123000``).
    The width is derived from ``fmt`` itself, then every window of that
    width in the basename is tried — strict strptime parsing makes false
    positives effectively impossible for real formats.
    """
    base = os.path.basename(ident)
    # a reference datetime with no repeated two-digit fields, so the
    # rendered width is the format's true fixed width
    width = len(datetime(2001, 12, 31, 23, 59, 58).strftime(fmt))
    for i in range(len(base) - width + 1):
        try:
            return datetime.strptime(base[i:i + width], fmt)
        except ValueError:
            continue
    return None


def bin_events(rows, starts_by_ident, bin_s: float = 3600.0):
    """Aggregate events into fixed wall-clock bins.

    ``rows`` are event dicts from
    :func:`buzzdetect_torch.write.detections.call_detections_directory`;
    ``starts_by_ident`` maps ident -> recording-start ``datetime``. Each
    event's detected span lands on the absolute timeline at
    ``start_dt + event seconds``; spans crossing a bin boundary are SPLIT
    proportionally (detected seconds are exact per bin), while the event
    COUNT goes to the bin containing the event's start. Bins align to the
    epoch of the earliest recording's midnight so day/hour bins land on
    calendar boundaries.

    Returns ``{(bin_start_datetime, class): {'n_events': int,
    'seconds': float}}``, only for non-empty bins.
    """
    if not (bin_s > 0):
        # a negative width would walk the split loop BACKWARD forever;
        # zero divides. Reject both instead of hanging the caller.
        raise ValueError(f'bin_s must be positive, got {bin_s}')
    if not rows:
        return {}
    missing = sorted({r['ident'] for r in rows}
                     - set(starts_by_ident))
    if missing:
        raise KeyError(f'no recording-start timestamp for ident(s): '
                       f'{missing}')
    day0 = min(starts_by_ident[r['ident']] for r in rows)
    epoch = day0.replace(hour=0, minute=0, second=0, microsecond=0)

    def bin_of(dt):
        k = int((dt - epoch).total_seconds() // bin_s)
        return epoch + timedelta(seconds=k * bin_s)

    out = {}

    def add(bin_start, cls, seconds, count):
        cell = out.setdefault((bin_start, cls),
                              {'n_events': 0, 'seconds': 0.0})
        cell['n_events'] += count
        cell['seconds'] += seconds

    for r in rows:
        t0 = starts_by_ident[r['ident']] + timedelta(seconds=r['start'])
        t1 = starts_by_ident[r['ident']] + timedelta(seconds=r['end'])
        add(bin_of(t0), r['class'], 0.0, 1)
        cur = t0
        while cur < t1:
            b = bin_of(cur)
            nxt = min(t1, b + timedelta(seconds=bin_s))
            add(b, r['class'], (nxt - cur).total_seconds(), 0)
            cur = nxt
    return out


def render_activity_csv(binned, path_out):
    """Write the binned activity as ``bin_start,class,n_events,
    detected_seconds`` (ISO timestamps, rows sorted by time then class)."""
    import csv
    with open(path_out, 'w', newline='') as f:
        w = csv.writer(f)
        w.writerow(('bin_start', 'class', 'n_events', 'detected_seconds'))
        for (b, cls), cell in sorted(binned.items()):
            w.writerow((b.isoformat(sep=' '), cls, cell['n_events'],
                        round(cell['seconds'], 3)))
    return path_out
