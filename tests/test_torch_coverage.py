"""tests/test_coverage.py, case for case, against ``buzzdetect_torch`` (import
prefix changed, same assertions). No edit beyond the import prefix.

The JAX package's docstring:

Unit tests for resume interval algebra (write/coverage.py).

The reference ships these functions untested (`src/stream/results_coverage.py`);
these tests encode their documented behavior as the oracle.
"""

import numpy as np
import pytest

from buzzdetect_torch.write.coverage import (
    melt_coverage, get_gaps, smooth_gaps, gaps_to_chunklist, coverage_from_csv)

FL = 0.96  # framelength seconds


def test_melt_merges_contiguous_frames():
    starts = np.arange(0, 10) * FL
    assert melt_coverage(starts, framelength=FL) == [(0.0, pytest.approx(9.6))]


def test_melt_detects_gap():
    starts = [0.0, 0.96, 5.0, 5.96]
    cov = melt_coverage(starts, framelength=FL)
    assert len(cov) == 2
    assert cov[0] == (0.0, pytest.approx(1.92))
    assert cov[1] == (5.0, pytest.approx(6.92))


def test_melt_unsorted_and_overlapping():
    starts = [5.0, 0.0, 0.5, 4.8]
    cov = melt_coverage(starts, framelength=FL)
    assert cov == [(0.0, pytest.approx(1.46)), (4.8, pytest.approx(5.96))]


def test_melt_empty():
    assert melt_coverage([], framelength=FL) == []


def test_melt_explicit_ends_running_max():
    # an interval fully containing its successor must not split coverage
    cov = melt_coverage([0.0, 1.0, 2.0], ends=[10.0, 3.0, 4.0])
    assert cov == [(0.0, 10.0)]


def test_get_gaps_ends_and_middle():
    gaps = get_gaps((0, 100), [(10, 20), (30, 40)])
    assert gaps == [(0, 10), (20, 30), (40, 100)]


def test_get_gaps_full_coverage():
    assert get_gaps((0, 10), [(0, 10)]) == []


def test_get_gaps_empty_coverage():
    assert get_gaps((0, 10), []) == [(0, 10)]


def test_smooth_drops_tail_gap():
    # gap starting within one framelength of range end: unanalyzable, drop
    gaps = [(99.5, 100.0)]
    assert smooth_gaps(gaps, (0, 100), FL, gap_tolerance=FL / 4) == []


def test_smooth_keeps_exact_final_frame_gap():
    """A tail gap whose single frame ends exactly at EOF must be KEPT: a
    9.6 s file interrupted after 8.64 s analyzed leaves (8.64, 9.6), and a
    fresh run emits that 10th frame — resume must too (regression: the
    strict `<` comparison, aggravated by 9.6-0.96 == 8.639999999999999,
    dropped it and finalized the file one row short, permanently)."""
    out = smooth_gaps([(8.64, 9.6)], (0, 9.6), FL, gap_tolerance=FL / 4)
    (lo, hi), = out  # float noise may route it through sub-frame widening
    assert lo == pytest.approx(8.64) and hi == pytest.approx(9.6)


def test_smooth_drops_subtolerance_gap():
    gaps = [(10.0, 10.1)]
    assert smooth_gaps(gaps, (0, 100), FL, gap_tolerance=FL / 4) == []


def test_smooth_expands_subframe_gap():
    # gap bigger than tolerance but smaller than a frame: widen to one frame
    # centered on the GAP so the re-analysis frame covers all of it
    gaps = [(10.0, 10.5)]
    out = smooth_gaps(gaps, (0, 100), FL, gap_tolerance=FL / 4)
    (lo, hi), = out
    assert hi - lo == pytest.approx(FL)
    assert lo <= 10.0 and hi >= 10.5  # the whole gap is covered


def test_smooth_subframe_gap_near_file_start_clamps():
    # a widened gap must never start before t=0 (negative timestamps)
    gaps = [(0.0, 0.5)]
    out = smooth_gaps(gaps, (0, 100), FL, gap_tolerance=FL / 4)
    (lo, hi), = out
    assert lo == 0.0
    assert hi == pytest.approx(FL)


def test_smooth_keeps_large_gap():
    gaps = [(10.0, 50.0)]
    assert smooth_gaps(gaps, (0, 100), FL, gap_tolerance=FL / 4) == [(10.0, 50.0)]


def test_chunklist_splits_and_rounds():
    chunks = gaps_to_chunklist([(0.0, 450.0)], 200.0)
    assert chunks == [(0.0, 200.0), (200.0, 400.0), (400.0, 450.0)]


def test_chunklist_exact_alignment_keeps_final_edge():
    chunks = gaps_to_chunklist([(0.0, 400.0)], 200.0)
    assert chunks == [(0.0, 200.0), (200.0, 400.0)]


def test_chunklist_multiple_gaps():
    chunks = gaps_to_chunklist([(0.0, 100.0), (300.0, 350.0)], 200.0)
    assert chunks == [(0.0, 100.0), (300.0, 350.0)]


def test_roundtrip_resume_cycle(tmp_path):
    """Full resume cycle: write a partial CSV, recover gaps, verify chunks."""
    duration = 300.0
    # analyzed [0, 96) and [192, 288): 100 frames each at framehop=1
    starts = np.concatenate([np.arange(100) * FL, 192 + np.arange(100) * FL])
    path = tmp_path / 'x_buzzpart.csv'
    with open(path, 'w') as f:
        f.write('start,activation_ins_buzz\n')
        for s in starts:
            f.write(f'{round(float(s), 2)},0.5\n')

    cov = coverage_from_csv(str(path), FL)
    gaps = get_gaps((0, duration), cov)
    # float-epsilon micro-gaps between merged frames are expected here;
    # the smoothing stage is the contract that removes them
    gaps = smooth_gaps(gaps, (0, duration), FL, gap_tolerance=FL / 4)
    chunks = gaps_to_chunklist(gaps, 200.0)
    # two remaining spans: [96, 192) and [288, 300)
    assert chunks[0][0] == pytest.approx(96.0, abs=0.01)
    assert chunks[0][1] == pytest.approx(192.0, abs=0.01)
    assert chunks[1][0] == pytest.approx(288.0, abs=0.01)
    assert chunks[1][1] == pytest.approx(300.0, abs=0.01)


def test_coverage_tolerates_torn_tail(tmp_path):
    """A SIGKILL mid-append can leave a torn final line; coverage parsing
    must skip it, not crash the resume."""
    path = tmp_path / 'x_buzzpart.csv'
    with open(path, 'w') as f:
        f.write('start,activation_ins_buzz\n')
        f.write('0.0,0.5\n')
        f.write('0.96,0.5\n')
        f.write('1.92')  # torn mid-row: start parseable, columns missing
    cov = coverage_from_csv(str(path), FL)
    # the torn frame at 1.92 must NOT count as covered
    assert cov == [(0.0, pytest.approx(1.92))]


def test_finalize_drops_torn_rows(tmp_path):
    from buzzdetect_torch.runtime.writer import finalize_partial
    partial = tmp_path / 'x_buzzpart.csv'
    complete = tmp_path / 'x_buzzdetect.csv'
    with open(partial, 'w') as f:
        f.write('start,activation_ins_buzz\n')
        f.write('0.96,0.5\n')
        f.write('1.92')  # torn mid-row
        f.write('\n0.0,0.7\n')
    finalize_partial(str(partial), str(complete))
    lines = open(complete).read().strip().split('\n')
    assert lines == ['start,activation_ins_buzz', '0.0,0.7', '0.96,0.5']


# --- randomized invariants ---------------------------------------------------

def _union_length(intervals):
    total = 0.0
    for s, e in intervals:
        total += max(0.0, e - s)
    return total


def test_coverage_algebra_randomized_invariants():
    """Property-style sweep of the resume algebra: for random frame sets the
    merged coverage must be sorted/disjoint and contain every input frame,
    gaps must exactly complement coverage inside the range, and
    subtract_interval must remove precisely the requested span."""
    import numpy as np
    from buzzdetect_torch.write.coverage import (melt_coverage, get_gaps,
                                               subtract_interval)
    rng = np.random.default_rng(7)
    fl = 0.96
    for _ in range(300):
        dur = float(rng.uniform(2.0, 60.0))
        n = int(rng.integers(0, 40))
        starts = np.round(rng.uniform(0, dur, n), 2)
        coverage = melt_coverage(starts, framelength=fl)

        # sorted, disjoint (touching intervals merged)
        for (s0, e0), (s1, e1) in zip(coverage, coverage[1:]):
            assert e0 < s1, (coverage,)
        # every frame is contained in exactly one merged interval
        for s in starts:
            assert any(lo <= s and s + fl <= hi + 1e-9
                       for lo, hi in coverage), (s, coverage)

        gaps = get_gaps((0.0, dur), coverage)
        # gaps are inside the range, disjoint from coverage, and together
        # with (range-clipped) coverage tile the whole range
        for lo, hi in gaps:
            assert 0.0 <= lo < hi <= dur + 1e-9
            for cs, ce in coverage:
                assert hi <= cs or lo >= ce, (gaps, coverage)
        clipped = [(max(0.0, s), min(dur, e)) for s, e in coverage
                   if e > 0.0 and s < dur]
        assert abs(_union_length(gaps) + _union_length(clipped) - dur) < 1e-6

        # subtracting a random span removes exactly its covered length
        lo = float(rng.uniform(0, dur))
        hi = lo + float(rng.uniform(0, dur / 2))
        covered_in_span = sum(
            max(0.0, min(e, hi) - max(s, lo)) for s, e in coverage)
        after = subtract_interval(coverage, lo, hi)
        for s, e in after:
            assert e <= lo or s >= hi  # nothing of the span survives
        assert abs(_union_length(after)
                   - (_union_length(coverage) - covered_in_span)) < 1e-6


def test_gap_chunk_roundtrip_closes_all_gaps():
    """Simulated resume convergence: analyzing exactly the chunks that
    gaps_to_chunklist emits must close every gap — if it ever leaves a
    sliver, a real resume would re-probe that file forever."""
    import numpy as np
    from buzzdetect_torch.write.coverage import (melt_coverage, get_gaps,
                                               smooth_gaps, gaps_to_chunklist)
    rng = np.random.default_rng(11)
    fl = 0.96
    for _ in range(100):
        dur = round(float(rng.uniform(5.0, 120.0)), 2)
        # random partial coverage (some prior analyzed frames)
        n = int(rng.integers(0, 20))
        starts = np.round(rng.uniform(0, max(0.1, dur - fl), n), 2)
        coverage = melt_coverage(starts, framelength=fl) if n else []
        gaps = smooth_gaps(get_gaps((0.0, dur), coverage), (0.0, dur),
                           framelength=fl, gap_tolerance=fl / 4)
        chunks = gaps_to_chunklist(gaps, chunklength=float(
            rng.uniform(2.0, 30.0)))
        # "analyze" each chunk: frames at stride fl from chunk start
        new_starts = list(starts)
        for lo, hi in chunks:
            t = lo
            while t + fl <= hi + 1e-9:
                new_starts.append(round(t, 2))
                t += fl
            if t < hi:  # ragged tail: the padded final frame
                new_starts.append(round(t, 2))
        full = melt_coverage(np.asarray(new_starts), framelength=fl)
        remaining = smooth_gaps(get_gaps((0.0, dur), full), (0.0, dur),
                                framelength=fl, gap_tolerance=fl / 4)
        assert not remaining, (dur, chunks, remaining)
