"""tests/test_activity.py, case for case, against ``buzzdetect_torch``
(import prefix changed, same assertions). Edit: the tool runs as
``python -m buzzdetect_torch.tools.activity_report`` from the repository's
root (the JAX cases run ``tools/activity_report.py``). The binning cases
also run the JAX package's ``bin_events`` on the same events and print
max |port - JAX| over the bins' seconds and counts
(``tests/test_torch_writers.py`` holds both packages' tables byte for
byte).

The JAX package's docstring:
Activity aggregation: events -> wall-clock buzz activity tables.

The 'sounds to stats' capability (reference defers it to its R companion,
`docs/source/index.rst:35`): recording start times recovered from
recorder-convention filenames, events split exactly across time bins.
"""

import os
import subprocess
import sys
from datetime import datetime

import pytest

from buzzdetect_torch.write.activity import (parse_ident_timestamp,
                                             bin_events, render_activity_csv)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = 'buzzdetect_torch.tools.activity_report'


def test_parse_ident_timestamp_conventions():
    want = datetime(2024, 6, 1, 12, 30, 0)
    assert parse_ident_timestamp('20240601_123000') == want
    # station prefix and suffix (SongMeter style), nested ident
    assert parse_ident_timestamp('HIVE3_20240601_123000') == want
    assert parse_ident_timestamp('site_a/HIVE3_20240601_123000_cut') == want
    # a different recorder convention via fmt
    assert parse_ident_timestamp('rec-2024-06-01T12-30-00',
                                 fmt='%Y-%m-%dT%H-%M-%S') == want
    assert parse_ident_timestamp('no_timestamp_here') is None
    # digits that aren't a valid datetime must not parse
    assert parse_ident_timestamp('99999999_999999') is None


def _bins_vs_jax(binned, events, starts, bin_s):
    """The JAX package's bins of the same events: the same keys; prints
    max |port - JAX| over their numbers."""
    from buzzdetect_tpu.write.activity import bin_events as jfn
    ref = jfn(events, starts, bin_s=bin_s)
    assert binned.keys() == ref.keys()
    err = max((abs(float(binned[k][f]) - float(v))
               for k in ref for f, v in ref[k].items()), default=0.0)
    print(f'{len(ref)} bins: max |port - JAX| = {err}')
    return err


def _event(ident, start, end, cls='ins_buzz'):
    return {'ident': ident, 'class': cls, 'start': start, 'end': end,
            'duration': end - start, 'n_frames': 1,
            'activation_max': 1.0, 'activation_mean': 0.5}


def test_bin_events_splits_boundaries_exactly():
    starts = {'a': datetime(2024, 6, 1, 11, 59, 0)}
    # event spans 11:59:30 -> 12:00:45: 30 s in the 11:00 bin, 45 s in 12:00
    binned = bin_events([_event('a', 30.0, 105.0)], starts, bin_s=3600.0)
    _bins_vs_jax(binned, [_event('a', 30.0, 105.0)], starts, 3600.0)
    h11 = binned[(datetime(2024, 6, 1, 11), 'ins_buzz')]
    h12 = binned[(datetime(2024, 6, 1, 12), 'ins_buzz')]
    assert h11['seconds'] == pytest.approx(30.0)
    assert h12['seconds'] == pytest.approx(45.0)
    # the event COUNT lands once, in the bin containing its start
    assert (h11['n_events'], h12['n_events']) == (1, 0)


def test_bin_events_day_bins_align_to_midnight():
    starts = {'a': datetime(2024, 6, 1, 23, 0, 0),
              'b': datetime(2024, 6, 2, 1, 0, 0)}
    binned = bin_events([_event('a', 0.0, 10.0), _event('b', 0.0, 5.0)],
                        starts, bin_s=86400.0)
    _bins_vs_jax(binned, [_event('a', 0.0, 10.0), _event('b', 0.0, 5.0)],
                 starts, 86400.0)
    assert set(b for b, _ in binned) == {datetime(2024, 6, 1),
                                         datetime(2024, 6, 2)}


def test_bin_events_missing_ident_and_empty():
    assert bin_events([], {}, bin_s=60.0) == {}
    with pytest.raises(KeyError, match='ghost'):
        bin_events([_event('ghost', 0.0, 1.0)], {}, bin_s=60.0)


def test_bin_events_rejects_nonpositive_width():
    """A negative width would walk the boundary-split loop backward
    forever; zero divides — both must fail loudly, not hang."""
    for bad in (-3600.0, 0.0):
        with pytest.raises(ValueError, match='positive'):
            bin_events([_event('r', 0.0, 1.0)],
                       {'r': datetime(2024, 6, 1)}, bin_s=bad)


def test_render_activity_csv(tmp_path):
    starts = {'a': datetime(2024, 6, 1, 10, 0, 0)}
    binned = bin_events([_event('a', 0.0, 2.5)], starts, bin_s=3600.0)
    path = render_activity_csv(binned, str(tmp_path / 'act.csv'))
    lines = open(path).read().splitlines()
    assert lines[0] == 'bin_start,class,n_events,detected_seconds'
    assert lines[1] == '2024-06-01 10:00:00,ins_buzz,1,2.5'


def test_activity_report_tool_end_to_end(tmp_path):
    """archived results (recorder-named) -> hourly table CSV + SVG."""
    d_res = tmp_path / 'out'
    d_res.mkdir()
    classes = ['ins_buzz', 'ambient_noise']

    def write_result(name, starts, buzz):
        with open(d_res / f'{name}_buzzdetect.csv', 'w') as f:
            f.write('start,' + ','.join(f'activation_{c}' for c in classes)
                    + '\n')
            for s, v in zip(starts, buzz):
                f.write(f'{s},{v},-5.0\n')

    starts = [i * 0.96 for i in range(6)]
    write_result('HIVE1_20240601_120000', starts,
                 [2.0, 2.0, -5.0, -5.0, -5.0, -5.0])
    write_result('HIVE1_20240601_130000', starts,
                 [-5.0, -5.0, -5.0, 3.0, -5.0, -5.0])

    out_csv = tmp_path / 'activity.csv'
    out_svg = tmp_path / 'activity.svg'
    proc = subprocess.run(
        [sys.executable, '-m', TOOL,
         '--dir_results', str(d_res), '--threshold', '0',
         '--out', str(out_csv), '--plot', str(out_svg)],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    lines = open(out_csv).read().splitlines()
    assert lines[1].startswith('2024-06-01 12:00:00,ins_buzz,1,')
    assert lines[2].startswith('2024-06-01 13:00:00,ins_buzz,1,')
    assert out_svg.exists() and out_svg.stat().st_size > 0


def test_activity_report_tool_threshold_flag_contract(tmp_path):
    """Same parser-level calibration contract as call_detections.py:
    exactly one of --threshold/--precision/--recall, recall in (0, 1]."""
    base = [sys.executable, '-m', TOOL, '--dir_results', str(tmp_path)]
    for extra, msg in (([], 'exactly one of'),
                       (['--threshold', '0', '--recall', '0.9'],
                        'exactly one of'),
                       (['--recall', '1.2'], 'must be in (0, 1]')):
        proc = subprocess.run(base + extra, capture_output=True, text=True,
                              timeout=120, cwd=REPO)
        assert proc.returncode == 2, proc.stderr
        assert msg in proc.stderr and 'Traceback' not in proc.stderr


def test_activity_report_tool_missing_timestamps(tmp_path):
    """Unparseable names fail with guidance, or skip with --allow_missing."""
    d_res = tmp_path / 'out'
    d_res.mkdir()
    with open(d_res / 'noname_buzzdetect.csv', 'w') as f:
        f.write('start,activation_ins_buzz\n0.0,2.0\n')
    base = [sys.executable, '-m', TOOL, '--dir_results', str(d_res),
            '--threshold', '0']
    proc = subprocess.run(base, capture_output=True, text=True, timeout=120,
                          cwd=REPO)
    assert proc.returncode != 0
    assert 'timestamp' in proc.stderr
    proc = subprocess.run(base + ['--allow_missing'], capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
