"""Interval algebra for resumable analysis.

A result CSV records one row per analyzed frame start time. On resume we
reconstruct which spans of the recording are already covered, compute the
gaps, clean up degenerate gaps, and split the gaps into analysis chunks.

Behavioral parity with reference `src/stream/results_coverage.py:4-70`
(melt_coverage / get_gaps / smooth_gaps / gaps_to_chunklist), re-implemented on
plain numpy. Differences: coverage merging uses a running-max end (robust to
non-uniform frame lengths), and empty coverage is handled instead of raising.
"""

import os

import numpy as np


def melt_coverage(starts, ends=None, framelength: float = None):
    """Merge per-frame [start, end) spans into a minimal list of covered intervals.

    ``starts`` is an array-like of frame start times; ``ends`` either given
    explicitly or derived as ``start + framelength``. Touching or overlapping
    spans merge. Returns a list of (start, end) tuples sorted by start.
    """
    starts = np.asarray(starts, dtype=np.float64)
    if starts.size == 0:
        return []
    if ends is None:
        if framelength is None:
            raise ValueError('provide ends or framelength')
        ends = starts + framelength
    else:
        ends = np.asarray(ends, dtype=np.float64)

    order = np.argsort(starts, kind='stable')
    starts, ends = starts[order], ends[order]

    merged = []
    cur_s, cur_e = starts[0], ends[0]
    for s, e in zip(starts[1:], ends[1:]):
        if s > cur_e:  # strict: touching intervals merge
            merged.append((float(cur_s), float(cur_e)))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    merged.append((float(cur_s), float(cur_e)))
    return merged


def get_gaps(range_in, coverage_in):
    """Complement of ``coverage_in`` within ``range_in = (lo, hi)``."""
    lo, hi = range_in
    coverage = sorted(coverage_in)
    if not coverage:
        return [(lo, hi)]

    gaps = []
    if coverage[0][0] > lo:
        gaps.append((lo, coverage[0][0]))
    for (s0, e0), (s1, _e1) in zip(coverage[:-1], coverage[1:]):
        if s1 > e0:
            gaps.append((e0, s1))
    if coverage[-1][1] < hi:
        gaps.append((coverage[-1][1], hi))
    return gaps


def smooth_gaps(gaps, range_in, framelength: float, gap_tolerance: float = None):
    """Clean degenerate gaps before chunking:

    * drop gaps that start within one frame of the range end (no full frame fits);
    * drop gaps no longer than ``gap_tolerance`` (float-noise gaps);
    * widen sub-frame gaps to exactly one frame, CENTERED on the gap and
      clamped inside the range, so the single re-analysis frame really covers
      the whole gap. (The reference anchors the widening at the gap start —
      its own comment says "expand from center" — which leaves up to half a
      frame of the gap uncovered and can produce negative start times for
      gaps near t=0; both fixed here.)
    """
    # keep a tail gap when one full frame still fits, INCLUDING the exact
    # boundary: a 9.6 s file interrupted after 8.64 s leaves gap (8.64, 9.6)
    # whose single frame ends exactly at EOF — a fresh run analyzes it, so
    # resume must too (one frame short otherwise). The epsilon absorbs float
    # noise: range_end - framelength computes to e.g. 8.639999999999999,
    # which a strict comparison against the CSV-rounded 8.64 would fail.
    tol = framelength * 1e-6
    gaps = [g for g in gaps if g[0] <= (range_in[1] - framelength) + tol]
    if gap_tolerance is not None:
        gaps = [g for g in gaps if (g[1] - g[0]) > gap_tolerance]
    out = []
    for g in gaps:
        if (g[1] - g[0]) < framelength:
            center = (g[0] + g[1]) / 2
            lo = max(range_in[0], center - framelength / 2)
            out.append((lo, lo + framelength))
        else:
            out.append(g)
    return out


def gaps_to_chunklist(gaps_in, chunklength: float, decimals: int = 2):
    """Split each gap into chunks of at most ``chunklength`` seconds.

    Chunk boundaries are rounded to ``decimals`` to keep result timestamps
    intelligible (floating-point noise would otherwise leak into filenames
    and resume math).
    """
    chunklist = []
    for lo, hi in gaps_in:
        points = np.arange(lo, hi, chunklength).tolist()
        points.append(hi)  # arange is right-exclusive even on exact alignment
        points = np.round(points, decimals)
        # rounding can collapse the final edge onto the previous point;
        # degenerate (zero/negative-length) chunks would fabricate result
        # rows from pure padding
        chunklist.extend((a, b) for a, b in zip(points[:-1], points[1:])
                         if b > a)
    return [(float(a), float(b)) for a, b in chunklist]


def read_result_rows(path: str):
    """Torn-row-tolerant result-CSV reader — the ONE definition of what
    counts as a valid row, shared by resume coverage and finalization (two
    divergent copies would desynchronize what resume re-analyzes from what
    finalization keeps).

    Returns ``(header, rows, torn_starts)``: ``rows`` are the complete
    validated rows (right column count, every cell float-parseable);
    ``torn_starts`` are the start times of INCOMPLETE rows whose start cell
    still parsed (an append tears at the end of a line, so the leading
    start cell usually survives) — resume uses them to force the torn
    frame's re-analysis even when overlapping neighbors cover its span.
    """
    import csv
    import io
    rows, torn_starts = [], []
    with open(path, 'r', newline='') as f:
        text = f.read()
    # every writer append is newline-terminated (formatting.render_csv), so
    # a final line WITHOUT one is torn mid-append even when it happens to
    # parse — '19.2,0.53\n' torn after '19.2,0.5' has the right column
    # count and every cell float-parseable, but the value is corrupt;
    # adopting it would bake the wrong activation into the finalized CSV
    # and never re-analyze the frame
    last_line_torn = bool(text) and not text.endswith(('\n', '\r'))
    reader = csv.reader(io.StringIO(text, newline=''))
    header = next(reader, None)
    if header is None or 'start' not in header:
        # empty file, or a SIGKILL tore the very first append mid-header:
        # the file is unusable — report no header so callers treat it as
        # empty coverage (full re-analysis) instead of raising; the
        # writer quarantines and rebuilds such partials on next append
        return None, [], []
    idx = header.index('start')
    n_cols = len(header)
    pending = list(reader)
    for i, row in enumerate(pending):
        if not row:
            continue
        complete = len(row) == n_cols
        if complete and last_line_torn and i == len(pending) - 1:
            complete = False
        if complete:
            try:
                [float(c) for c in row]
            except ValueError:
                complete = False
        if complete:
            rows.append(row)
        else:
            try:
                torn_starts.append(float(row[idx]))
            except (ValueError, IndexError):
                pass  # even the start cell is gone; nothing to locate
    return header, rows, torn_starts


def quarantine_partial(path_partial: str) -> str:
    """Move an unusable partial aside to ``<partial>.corrupt`` (overwrite-
    safe) and return the quarantine path — the ONE definition of the
    quarantine convention, shared by the writer's header verification and
    the streamer's self-heal path."""
    path_corrupt = path_partial + '.corrupt'
    os.replace(path_partial, path_corrupt)
    return path_corrupt


def subtract_interval(coverage, lo, hi):
    """Remove [lo, hi) from a merged coverage list."""
    out = []
    for s, e in coverage:
        if e <= lo or s >= hi:
            out.append((s, e))
            continue
        if s < lo:
            out.append((s, lo))
        if e > hi:
            out.append((hi, e))
    return out


def coverage_from_csv(path: str, framelength: float,
                      framehop: float = None):
    """Read a (partial) result CSV and return merged covered intervals.

    Only the ``start`` column matters; every row attests one analyzed frame.
    A SIGKILL mid-append can tear the final line — unparseable trailing rows
    are dropped AND their span is subtracted from the coverage, so the torn
    frame is re-analyzed even at overlapping framehops (< 1), where
    neighboring rows would otherwise cover its span and finalization would
    drop it without a replacement.

    ``framehop`` (seconds): at sparse framehops (> framelength) a row
    attests the whole stride to the next expected row — melting with only
    the framelength would read every inter-row stride as a gap and resume
    would re-analyze an already-sampled sparse run frame by frame.
    """
    header, rows, torn_starts = read_result_rows(path)
    return coverage_from_rows(header, rows, torn_starts, framelength,
                              framehop)


def coverage_from_rows(header, rows, torn_starts, framelength: float,
                       framehop: float = None):
    """``coverage_from_csv`` on an already-parsed ``read_result_rows``
    triple — callers that also need the rows themselves (the streamer's
    resume path distinguishes debris from finished-but-unfinalized) parse
    the partial once instead of three times."""
    if header is None or not rows:
        return []
    idx = header.index('start')
    starts = np.array([float(r[idx]) for r in rows])
    span = max(framelength, framehop or 0.0)
    coverage = melt_coverage(starts, framelength=span)
    for s in torn_starts:
        coverage = subtract_interval(coverage, s, s + span)
    return coverage
