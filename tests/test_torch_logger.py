"""tests/test_logger.py, case for case, against ``buzzdetect_torch`` (import
prefix changed, same assertions). No edit beyond the import prefix.

The JAX package's docstring:

Logger worker unit tests: file/console verbosity split, PROGRESS
suppression in the file handler, GUI fan-out, termination.
"""

import queue
import threading

import pytest

from buzzdetect_torch.runtime.assignments import AssignLog
from buzzdetect_torch.runtime.logger import WorkerLogger


class FakeCoordinator:
    def __init__(self, q_gui=None):
        self.q_log = queue.Queue()
        self.q_gui = q_gui


def run_logger(tmp_path, records, q_gui=None, **kwargs):
    coord = FakeCoordinator(q_gui=q_gui)
    path = str(tmp_path / 'run.log')
    w = WorkerLogger(path_log=path, coordinator=coord, **kwargs)
    for r in records:
        coord.q_log.put(r)
    coord.q_log.put(AssignLog(message='', level_str='INFO', terminate=True))
    t = threading.Thread(target=w.run)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    with open(path) as f:
        return f.read()


def test_progress_dropped_from_file_by_default(tmp_path):
    text = run_logger(tmp_path, [
        AssignLog(message='rate line', level_str='PROGRESS'),
        AssignLog(message='info line', level_str='INFO'),
    ])
    assert 'info line' in text
    assert 'rate line' not in text  # PROGRESS spam kept out of the log file


def test_progress_kept_with_log_progress(tmp_path):
    text = run_logger(tmp_path, [
        AssignLog(message='rate line', level_str='PROGRESS'),
    ], log_progress=True)
    assert 'rate line' in text
    assert '[PROGRESS]' in text


def test_file_verbosity_threshold(tmp_path):
    text = run_logger(tmp_path, [
        AssignLog(message='debug line', level_str='DEBUG'),
        AssignLog(message='warn line', level_str='WARNING'),
    ], verbosity_log='WARNING')
    assert 'warn line' in text
    assert 'debug line' not in text


def test_gui_fanout_respects_console_verbosity(tmp_path):
    q_gui = queue.Queue()
    run_logger(tmp_path, [
        AssignLog(message='debug line', level_str='DEBUG'),
        AssignLog(message='warn line', level_str='WARNING'),
    ], q_gui=q_gui, verbosity_print='WARNING')
    fanned = []
    while not q_gui.empty():
        fanned.append(q_gui.get().message)
    assert 'warn line' in fanned
    assert 'debug line' not in fanned


def test_timestamps_have_milliseconds(tmp_path):
    import re
    text = run_logger(tmp_path, [AssignLog(message='x', level_str='INFO')])
    assert re.search(r'\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2}\.\d{3} \[INFO\]',
                     text)


def test_file_sink_flushes_per_record(tmp_path):
    """Crash triage depends on the newest records being ON DISK before
    termination — the sink must flush per record, not on close (a SIGKILL
    mid-run would otherwise lose the stdio buffer's tail, exactly the most
    diagnostic lines)."""
    coord = FakeCoordinator()
    path = str(tmp_path / 'run.log')
    w = WorkerLogger(path_log=path, coordinator=coord)
    coord.q_log.put(AssignLog(message='landed', level_str='INFO'))
    t = threading.Thread(target=w.run, daemon=True)
    t.start()
    deadline = 50
    while deadline and 'landed' not in open(path).read():
        import time
        time.sleep(0.1)
        deadline -= 1
    # read BEFORE the terminate record (which closes/flushes everything)
    assert 'landed' in open(path).read()
    coord.q_log.put(AssignLog(message='', level_str='INFO', terminate=True))
    t.join(timeout=10)
