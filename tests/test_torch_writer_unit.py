"""tests/test_writer_unit.py, case for case, against ``buzzdetect_torch``
(import prefix changed, same assertions). No edit beyond the import prefix.

The JAX package's docstring:

Writer unit tests: the failed-chunk / failed-append finalization guards
(data-integrity invariant: a file with any hole stays a resumable partial).
"""

import os
import queue
import threading

import numpy as np
import pytest

from buzzdetect_torch.runtime.assignments import AssignFile, AssignChunk
from buzzdetect_torch.runtime.writer import WorkerWriter


class FakeCoordinator:
    def __init__(self):
        self.q_log = queue.Queue()
        self.q_write = queue.Queue()
        self.writer_done = threading.Event()
        self.audio = 0.0

    def worker_exited(self, kind):
        pass  # protocol hook; exit accounting is the real Coordinator's job

    def get_write(self):
        return self.q_write.get()

    def record_written(self, seconds):
        self.audio += seconds

    def record_finalized(self):
        pass

    def stream_failed(self, ident):
        return False


def _writer(tmp_path):
    coord = FakeCoordinator()
    w = WorkerWriter(classes_out='all', threshold=None, classes=['a', 'b'],
                     framehop_s=0.96, digits_time=2, digits_results=2,
                     coordinator=coord)
    return w, coord


def _chunk(tmp_path, span, results, last=False):
    f = AssignFile(path_audio=str(tmp_path / 'x.wav'),
                   dir_audio=str(tmp_path), dir_results=str(tmp_path))
    return AssignChunk(file=f, chunk=span, last_chunk=last, results=results)


def test_failed_chunk_blocks_finalization(tmp_path):
    w, coord = _writer(tmp_path)
    good = np.zeros((2, 2))

    w.write_results(_chunk(tmp_path, (0.0, 1.92), good), fully_analyzed=False)
    # chunk 2 failed upstream (results=None), and it happens to be the last
    w.write_results(_chunk(tmp_path, (1.92, 3.84), None), fully_analyzed=True)

    assert os.path.exists(tmp_path / 'x_buzzpart.csv')
    assert not os.path.exists(tmp_path / 'x_buzzdetect.csv')


def test_failed_append_blocks_finalization(tmp_path, monkeypatch):
    """An IO error during the partial append must also mark the file failed
    (exercises the run()-level except path)."""
    w, coord = _writer(tmp_path)
    good = np.zeros((2, 2))

    c1 = _chunk(tmp_path, (0.0, 1.92), good)
    c2 = _chunk(tmp_path, (1.92, 3.84), good)
    c3 = _chunk(tmp_path, (3.84, 5.76), good, last=True)

    coord.q_write.put((c1, False))
    coord.q_write.put((c2, False))
    coord.q_write.put((c3, True))
    coord.q_write.put('exit')

    # make chunk 2's append explode inside write_results
    real = w.format

    def flaky(results, time_start):
        if time_start == 1.92:
            raise OSError('disk full')
        return real(results=results, time_start=time_start)

    w.format = flaky
    w.run()

    # chunk 2 is a hole: partial kept, complete never written
    assert os.path.exists(tmp_path / 'x_buzzpart.csv')
    assert not os.path.exists(tmp_path / 'x_buzzdetect.csv')
    assert 'x' in w.failed_idents


def test_clean_file_finalizes(tmp_path):
    w, coord = _writer(tmp_path)
    good = np.ones((2, 2)) * 0.5
    w.write_results(_chunk(tmp_path, (0.0, 1.92), good), fully_analyzed=False)
    w.write_results(_chunk(tmp_path, (1.92, 3.84), good), fully_analyzed=True)
    assert not os.path.exists(tmp_path / 'x_buzzpart.csv')
    assert os.path.exists(tmp_path / 'x_buzzdetect.csv')
    assert coord.audio == pytest.approx(3.84)


def test_alert_lines_times_and_peak(tmp_path):
    """Opt-in live alerts: one WARNING line per (chunk, class) with the
    detected frame span and peak; silent when nothing exceeds."""
    coord = FakeCoordinator()
    w = WorkerWriter(classes_out='all', threshold=None, classes=['a', 'b'],
                     framehop_s=0.96, digits_time=2, digits_results=2,
                     coordinator=coord, alert=(['b'], [1], 0.5, 0.96))
    results = np.array([[0.0, 0.0],
                        [0.0, 0.9],
                        [0.0, 0.7],
                        [0.0, 0.0]])
    w.write_results(_chunk(tmp_path, (9.6, 13.44), results),
                    fully_analyzed=False)
    msgs = []
    while not coord.q_log.empty():
        msgs.append(coord.q_log.get())
    alerts = [m for m in msgs if 'DETECTED' in m.message]
    assert len(alerts) == 1
    assert alerts[0].level_str == 'WARNING'
    # frames 1..2 of a chunk starting at 9.6 s -> 10.56 to 12.48 s
    assert alerts[0].message == \
        'DETECTED b in x: 2 frame(s) 10.56-12.48s (peak activation 0.90)'

    # below threshold: no alert line
    w.write_results(_chunk(tmp_path, (13.44, 17.28),
                           np.full((4, 2), 0.4)), fully_analyzed=False)
    while not coord.q_log.empty():
        assert 'DETECTED' not in coord.q_log.get().message


def test_alert_span_uses_framelength_not_framehop(tmp_path):
    """At framehop_prop != 1 the span end is last start + FRAME length (the
    audio the model scored), not last start + hop."""
    coord = FakeCoordinator()
    w = WorkerWriter(classes_out='all', threshold=None, classes=['a', 'b'],
                     framehop_s=0.48, digits_time=2, digits_results=2,
                     coordinator=coord, alert=(['b'], [1], 0.5, 0.96))
    results = np.array([[0.0, 0.0],
                        [0.0, 0.9],
                        [0.0, 0.0],
                        [0.0, 0.0]])
    w.write_results(_chunk(tmp_path, (9.6, 11.52), results),
                    fully_analyzed=False)
    msgs = []
    while not coord.q_log.empty():
        msgs.append(coord.q_log.get())
    alerts = [m for m in msgs if 'DETECTED' in m.message]
    # hit frame starts at 9.6 + 0.48 = 10.08 and covers 0.96 s of audio
    assert len(alerts) == 1
    assert '1 frame(s) 10.08-11.04s' in alerts[0].message


def test_alert_failure_never_blocks_finalization(tmp_path):
    """Alerts are advisory: an exception inside alert emission must not
    mark the file failed — results still append and the file finalizes."""
    coord = FakeCoordinator()
    # index 5 is out of range for 2-class results -> _emit_alerts raises
    w = WorkerWriter(classes_out='all', threshold=None, classes=['a', 'b'],
                     framehop_s=0.96, digits_time=2, digits_results=2,
                     coordinator=coord, alert=(['ghost'], [5], 0.0, 0.96))
    good = np.ones((2, 2)) * 0.5
    w.write_results(_chunk(tmp_path, (0.0, 1.92), good), fully_analyzed=True)
    assert 'x' not in w.failed_idents
    assert os.path.exists(tmp_path / 'x_buzzdetect.csv')
    msgs = []
    while not coord.q_log.empty():
        msgs.append(coord.q_log.get().message)
    assert any('alert emission failed' in m for m in msgs)


def _alert_msgs(coord):
    msgs = []
    while not coord.q_log.empty():
        m = coord.q_log.get()
        if 'DETECTED' in m.message:
            msgs.append(m.message)
    return msgs


def test_alert_reproducible_from_activations_archive(tmp_path):
    """Activations mode archives round(scores, digits_results), so the alert
    comparison must use the same rounded values: a raw -1.996 vs threshold
    -2.0 must NOT alert (the archived -2.0 could never confirm it), while a
    raw 0.506 must alert as 0.51 — exactly what re-thresholding the CSV
    yields."""
    coord = FakeCoordinator()
    w = WorkerWriter(classes_out='all', threshold=None, classes=['a', 'b'],
                     framehop_s=0.96, digits_time=2, digits_results=2,
                     coordinator=coord, alert=(['b'], [1], -2.0, 0.96))
    # -1.996 rounds to -2.00, which is not > -2.0: no phantom alert
    w.write_results(_chunk(tmp_path, (0.0, 1.92),
                           np.array([[0.0, -1.996], [0.0, -2.3]])),
                    fully_analyzed=False)
    assert _alert_msgs(coord) == []

    w2 = WorkerWriter(classes_out='all', threshold=None, classes=['a', 'b'],
                      framehop_s=0.96, digits_time=2, digits_results=2,
                      coordinator=coord, alert=(['b'], [1], 0.5, 0.96))
    w2.write_results(_chunk(tmp_path, (0.0, 1.92),
                            np.array([[0.0, 0.506], [0.0, 0.0]])),
                     fully_analyzed=False)
    msgs = _alert_msgs(coord)
    assert len(msgs) == 1
    # the peak is the ROUNDED value the archive holds, at digits_results
    assert '(peak activation 0.51)' in msgs[0]


def test_alert_matches_detections_archive_unrounded(tmp_path):
    """Detections mode thresholds the raw scores (write/formatting.py
    format_detections), so the alert mirrors that: a raw 0.504 vs threshold
    0.5 alerts, in lockstep with the d_ins_buzz=1 row it lands next to."""
    coord = FakeCoordinator()
    w = WorkerWriter(classes_out=None, threshold=0.5,
                     classes=['a', 'ins_buzz'], framehop_s=0.96,
                     digits_time=2, digits_results=2, coordinator=coord,
                     alert=(['ins_buzz'], [1], 0.5, 0.96))
    w.write_results(_chunk(tmp_path, (0.0, 1.92),
                           np.array([[0.0, 0.504], [0.0, 0.0]])),
                    fully_analyzed=False)
    msgs = _alert_msgs(coord)
    assert len(msgs) == 1
    # the peak prints the RAW value (enough digits to visibly exceed the
    # threshold), not rounded back below it
    assert '(peak activation 0.504)' in msgs[0]
    # and the archived detections row agrees
    with open(tmp_path / 'x_buzzpart.csv') as f:
        body = f.read().splitlines()
    assert body[1].endswith(',1')


def test_alert_peak_honors_digits_results(tmp_path):
    """The peak in the alert line renders at the writer's digits_results,
    matching the precision of every value in the result files."""
    coord = FakeCoordinator()
    w = WorkerWriter(classes_out='all', threshold=None, classes=['a', 'b'],
                     framehop_s=0.96, digits_time=2, digits_results=3,
                     coordinator=coord, alert=(['b'], [1], 0.5, 0.96))
    w.write_results(_chunk(tmp_path, (0.0, 1.92),
                           np.array([[0.0, 0.9004], [0.0, 0.0]])),
                    fully_analyzed=False)
    msgs = _alert_msgs(coord)
    assert len(msgs) == 1
    assert '(peak activation 0.900)' in msgs[0]


def test_alert_detections_float32_bit_parity(tmp_path):
    """Detections mode must compare in the scores' raw dtype exactly like
    format_detections: float32(0.503) is not > 0.503 in float32 (they cast
    equal) but IS in float64 (0.50300002...) — a float64 cast in the alert
    path would fire on a score the archived d_ row rejects."""
    coord = FakeCoordinator()
    thr = 0.503
    w = WorkerWriter(classes_out=None, threshold=thr,
                     classes=['a', 'ins_buzz'], framehop_s=0.96,
                     digits_time=2, digits_results=2, coordinator=coord,
                     alert=(['ins_buzz'], [1], thr, 0.96))
    w.write_results(_chunk(tmp_path, (0.0, 1.92),
                           np.array([[0.0, thr]], dtype=np.float32)),
                    fully_analyzed=False)
    assert _alert_msgs(coord) == []
    with open(tmp_path / 'x_buzzpart.csv') as f:
        assert f.read().splitlines()[1].endswith(',0')
