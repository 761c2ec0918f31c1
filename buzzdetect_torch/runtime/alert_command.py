"""Run a user-supplied command on each live detection alert.

The last mile of field monitoring: ``analyze(watch=True,
alert_classes=...)`` already announces detections in the log the moment
scores land; ``alert_command=`` turns each announcement into an action —
an SMS gateway call, an MQTT publish, a speaker beep — without the
operator tailing a log. The reference has no notification hook at all
(its closest surface is reading result files after the run); this is a
deliberate superset shaped by the same need its watch-style deployments
describe.

Design rules (all about never hurting the analysis):

* The writer NEVER blocks on a notification. Alerts enqueue onto a small
  bounded queue drained by one daemon thread; when the queue is full
  (a slow command during an alert storm) new alerts are DROPPED and
  counted — the log line archive remains the complete record.
* Commands run through the shell (the command string is user-authored
  configuration, the same trust level as the CLI itself), but event data
  is passed ONLY via environment variables — class names and file idents
  never interpolate into shell syntax, so hostile filenames can't inject.
* One command at a time, killed (whole process group) after
  ``timeout_s``: a hung notifier degrades to dropped notifications, never
  to an unbounded process/thread pile (watch mode builds one runner per
  polling cycle — see tools/soak_watch.py's bounded-residue assertions).
  A hook that deliberately backgrounds work (``notify.sh &``) returns as
  soon as its shell does and is NOT treated as hung.
* ``close()`` is bounded AND terminal: it waits briefly for queued
  notifications to ship, then ABANDONS the dispatch — the drain thread
  stops launching new commands (at most the one in flight finishes or is
  killed), drains the leftovers as counted drops, and exits. A slow
  notifier can therefore never stall the writer join, and per-cycle
  runners in watch mode never stack concurrent notifier processes.
* Failures warn ONCE per run and are counted; the summary lands in the
  log at close. An alert command that exits non-zero must not bury the
  DETECTED lines it exists to amplify.
"""

import os
import queue
import signal
import subprocess
import tempfile
import threading

# generous headroom for a notification hop (an HTTP POST, a mail relay);
# anything slower is effectively hung and gets killed so the queue drains
COMMAND_TIMEOUT_S = 30.0
QUEUE_DEPTH = 64


class AlertCommandRunner:
    """One per analysis run (owned by the writer worker)."""

    def __init__(self, command: str, log, depth: int = QUEUE_DEPTH,
                 timeout_s: float = COMMAND_TIMEOUT_S):
        self.command = command
        self.log = log  # callable(message, level_str) -> the run's log
        self.timeout_s = timeout_s
        self._q = queue.Queue(maxsize=depth)
        # _dropped is bumped from three threads (writer via submit, the
        # drain thread, close()'s caller); += is a non-atomic
        # read-modify-write, so an unlocked storm would undercount the
        # very drops the summary promises to report
        self._drop_lock = threading.Lock()
        self._dropped = 0
        self._failures = 0
        self._warned = False
        self._launched = 0
        # _closing: stop waiting for NEW alerts — exit once the queue
        # empties. _abandoned: stop SHIPPING — drain leftovers as drops
        # and exit; set when close()'s bounded wait expires.
        self._closing = threading.Event()
        self._abandoned = threading.Event()
        self._summary_done = False
        self._thread = threading.Thread(target=self._drain, daemon=True,
                                        name='alert-command')
        self._thread.start()

    def submit(self, fields: dict):
        """Enqueue one alert (non-blocking; drops when the queue is full)."""
        try:
            self._q.put_nowait(dict(fields))
        except queue.Full:
            with self._drop_lock:
                self._dropped += 1

    def _drain(self):
        while not self._abandoned.is_set():
            try:
                fields = self._q.get(timeout=0.25)
            except queue.Empty:
                if self._closing.is_set():
                    return  # shipped everything queued before close
                continue
            if self._abandoned.is_set():
                with self._drop_lock:
                    self._dropped += 1
                continue
            self._run_one(fields)
        # abandoned: never execute another command — count the leftovers
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                return
            with self._drop_lock:
                self._dropped += 1

    def _run_one(self, fields):
        # stderr goes to an unlinked temp FILE, not a pipe: the common
        # `notify.sh &` idiom leaves a grandchild holding stderr open, and
        # a pipe would make us block until ITS eof (a 30 s false "hung"
        # per alert for a command that exited instantly). wait() reads no
        # pipes, so a backgrounded hook returns as fast as its shell does
        # — and a chatty hook can never deadlock on a full pipe buffer.
        env = dict(os.environ)
        env.update({f'BUZZ_{k.upper()}': str(v) for k, v in fields.items()})
        self._launched += 1
        try:
            with tempfile.TemporaryFile() as errf:
                proc = subprocess.Popen(
                    self.command, shell=True, env=env,
                    stdout=subprocess.DEVNULL, stderr=errf,
                    start_new_session=True)
                try:
                    rc = proc.wait(timeout=self.timeout_s)
                except subprocess.TimeoutExpired:
                    # kill the whole process group (start_new_session made
                    # the shell its leader): "hung commands are killed"
                    # must include whatever the shell spawned, or the hung
                    # worker survives the shell's SIGKILL
                    try:
                        os.killpg(proc.pid, signal.SIGKILL)
                    except (ProcessLookupError, PermissionError):
                        proc.kill()
                    proc.wait()
                    self._failure(
                        f'killed after {self.timeout_s:.0f}s timeout')
                    return
                if rc != 0:
                    errf.seek(0, os.SEEK_END)
                    size = errf.tell()
                    errf.seek(max(0, size - 1024))
                    err = errf.read().decode(errors='replace').strip()[-200:]
                    self._failure(f'exit {rc}' + (f': {err}' if err else ''))
        except Exception as e:
            self._failure(str(e))

    def _failure(self, detail):
        self._failures += 1
        if not self._warned and not self._abandoned.is_set():
            # after abandonment the run's log channel is shutting down —
            # count silently; the close summary already landed
            self._warned = True
            self.log(f'alert command failed ({detail}); counting further '
                     f'failures silently — see the run summary', 'WARNING')

    def stats(self) -> dict:
        """Counter snapshot for the machine-readable run summary.

        Call after ``close()``. The counts are final EXCEPT when close
        abandoned dispatch with a command still in flight: that command
        resolves on the daemon thread up to ``timeout_s`` later and may
        add one more failure after this snapshot, and the thread then
        drains any leftover queue entries into ``dropped`` — so while
        ``final`` is False, BOTH ``failures`` and ``dropped`` may still
        move (each is a lower bound; the direction of error is
        conservative). ``final: False`` marks the summary in exactly that
        case (the log lines remain the complete record either way)."""
        with self._drop_lock:
            dropped = self._dropped
        in_flight = self._abandoned.is_set() and self._thread.is_alive()
        return {'launched': int(self._launched),
                'failures': int(self._failures),
                'dropped': int(dropped),
                'final': not in_flight}

    def close(self, timeout: float = 5.0):
        """Stop accepting, drain briefly, abandon what's left, summarize.

        Bounded by construction: waits at most ``timeout`` for queued
        notifications to ship, then flips the drain to drop-and-exit — at
        most the single in-flight command remains, on a daemon thread,
        under its own kill timeout. Idempotent (watch/fatal paths may
        close twice)."""
        if self._summary_done:
            return
        self._summary_done = True
        self._closing.set()
        self._thread.join(timeout)
        if self._thread.is_alive():
            self._abandoned.set()
            # count the stranded backlog HERE, before the summary below —
            # the drain thread is parked inside the in-flight command (up
            # to timeout_s more) and would only add these drops after
            # close() returned, making the summary undercount exactly in
            # the abandonment case. Each alert is popped once (here, or by
            # the thread's own leftover loop), so nothing double-counts.
            stranded = 0
            while True:
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    break
                stranded += 1
            with self._drop_lock:
                self._dropped += stranded
            self.log(f'alert command still running at shutdown; abandoning '
                     f'dispatch ({stranded} queued notification(s) '
                     f'dropped; the in-flight command is killed after its '
                     f'{self.timeout_s:.0f}s timeout)', 'WARNING')
        if self._dropped:
            self.log(f'alert command: {self._dropped} alert(s) dropped '
                     f'(command slower than the alert rate; the DETECTED '
                     f'log lines remain complete)', 'WARNING')
        if self._failures:
            self.log(f'alert command: {self._failures} of '
                     f'{self._launched} invocation(s) failed', 'WARNING')
