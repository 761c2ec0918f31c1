"""Log-drain worker: pulls ``AssignLog`` records off the coordinator's
``q_log`` and fans each one out to the run-log file, the console stream,
and (when present) the GUI queue, each behind its own admission rule.

Behavioral contract shared with the reference's logger worker
(`src/pipeline/logger.py:11-67`): millisecond-resolution timestamps in the
``YYYY-MM-DD HH:MM:SS.mmm [LEVEL] message`` shape, independent console and
file verbosity thresholds, PROGRESS records kept out of the log file by
default (per-chunk rate reports would bloat it to megabytes), and GUI
fan-out of every record at or above console verbosity. The implementation
here is deliberately its own: a single drain loop dispatching to plain
file/stream sinks, with lazy one-shot line rendering, instead of the stdlib
``logging`` handler/filter/formatter stack.
"""

import sys
from datetime import datetime

from buzzdetect_torch.loglevels import PROGRESS, loglevels
from buzzdetect_torch.runtime.assignments import AssignLog

# Reverse lookup for rendering: numeric level -> canonical name.
_LEVEL_NAME = {num: name for name, num in loglevels.items()}


def render_line(record: AssignLog, when: datetime | None = None) -> str:
    """Format one record as a log line with millisecond timestamps."""
    when = when or datetime.now()
    stamp = f"{when:%Y-%m-%d %H:%M:%S}.{when.microsecond // 1000:03d}"
    level = _LEVEL_NAME.get(record.level_int, str(record.level_int))
    return f"{stamp} [{level}] {record.message}"


class WorkerLogger:
    """Drains ``coordinator.q_log`` until a ``terminate`` record arrives.

    The file sink admits records at/above ``verbosity_log`` but drops
    PROGRESS unless ``log_progress`` is set; the console sink admits
    records at/above ``verbosity_print`` and mirrors everything it prints
    to the GUI queue when one is attached.
    """

    def __init__(self, path_log, coordinator, verbosity_print='PROGRESS',
                 verbosity_log='DEBUG', log_progress=False):
        self.coordinator = coordinator
        self._min_console = loglevels[verbosity_print]
        self._min_file = loglevels[verbosity_log]
        self._file_takes_progress = log_progress
        self._logfile = open(path_log, 'a', encoding='utf-8')

    def __call__(self):
        self.run()

    def _file_admits(self, record: AssignLog) -> bool:
        if record.level_int < self._min_file:
            return False
        return self._file_takes_progress or record.level_int != PROGRESS

    def _emit(self, record: AssignLog):
        line = None  # rendered at most once, shared by every sink
        if self._file_admits(record):
            line = render_line(record)
            self._logfile.write(line + '\n')
            # per-record flush: the run log's whole point is crash triage
            # (SIGKILL/power loss), so the newest records must be on disk,
            # and a live `tail -f` must see them — file-admitted volume is
            # low (PROGRESS is dropped by default)
            self._logfile.flush()
        if record.level_int >= self._min_console:
            line = line if line is not None else render_line(record)
            print(line, file=sys.stderr, flush=True)
            if self.coordinator.q_gui is not None:
                self.coordinator.q_gui.put(record)

    def run(self):
        while True:
            record = self.coordinator.q_log.get()
            if record.terminate:
                break
            self._emit(record)
        self._emit(AssignLog(message='log drain stopped', level_str='DEBUG'))
        self._logfile.flush()
        self._logfile.close()
