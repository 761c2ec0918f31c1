"""Writer worker: results -> partial CSV appends -> finalized result files.

This is the checkpoint authority (parity: reference `src/write/worker.py:10-100`):
each chunk's rows append to ``<ident>_buzzpart.csv`` (header only on create) —
that append IS the unit of resumable progress — and when a file's last chunk
lands the partial is read back, sorted by start time, written to
``<ident>_buzzdetect.csv`` and the partial removed.
"""

import csv
import os

import numpy as np

from buzzdetect_torch.runtime.assignments import AssignChunk, AssignLog
from buzzdetect_torch.runtime.spans import chunk_of, mark, span
from buzzdetect_torch.write.formatting import format_activations, format_detections


def finalize_partial(path_partial: str, path_complete: str):
    """Sort a partial result CSV by start time and promote it to complete.

    Torn rows (a SIGKILL can interrupt an append mid-line) are dropped — the
    resume logic never counted them as covered (and subtracts their span),
    so a complete replacement row exists by the time finalization runs.

    Promotion is ATOMIC (write to temp + rename): a crash or disk-full
    mid-promotion must never leave a truncated complete file, because every
    later run trusts a complete file's existence and would skip the file
    forever.
    """
    from buzzdetect_torch.write.coverage import read_result_rows
    header, rows, _torn = read_result_rows(path_partial)
    if header is None:
        # empty/torn-header partial: promoting it would write a complete
        # file carrying none of the analysis and skip the file forever
        raise ValueError(f'partial result {path_partial} has no usable '
                         f'header; refusing to promote it')
    idx = header.index('start')
    rows.sort(key=lambda r: float(r[idx]))
    path_tmp = path_complete + '.tmp'
    with open(path_tmp, 'w', newline='') as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)
        # fsync BEFORE the rename: without it a power loss inside the
        # writeback window can persist the directory entry but not the
        # data (ext4 writeback / XFS / btrfs), leaving the truncated
        # complete file this function's atomicity exists to prevent
        f.flush()
        os.fsync(f.fileno())
    os.replace(path_tmp, path_complete)
    os.remove(path_partial)


def _materialize(results, n_valid):
    """Device->host materialization of a chunk's scores — the pipeline's
    device sync point (by now the inferer has already dispatched the next
    chunk). A copy in flight (runtime/inferer.HostCopy) is waited on
    through its CUDA event; CPU tensors and numpy convert directly. Split
    into its own frame so stack-sampling host profiles attribute the device
    wait separately from the writer's real CSV work, and a profiler trace
    holds it as ``buzzdetect.wait`` with the chunk's id
    (``runtime/spans.py``)."""
    with span('buzzdetect.wait'):
        mark(chunk_of(results))
        wait = getattr(results, 'wait', None)
        results = np.asarray(wait() if wait is not None else results)
    if n_valid is not None:
        results = results[:n_valid]
    return results


class WorkerWriter:
    def __init__(self, classes_out, threshold, classes, framehop_s,
                 digits_time, digits_results, coordinator, alert=None,
                 alert_command=None):
        self.coordinator = coordinator
        self.digits_time = digits_time
        self.digits_results = digits_results
        # live detection alerts: (names, column indices, threshold,
        # framelength_s) or None. Emitted the moment a chunk's scores
        # materialize (before the CSV append) so a watch-mode operator hears
        # about a buzz in near real time instead of after reviewing result
        # files.
        self.alert = alert
        # Every alert must reproduce from the result files it points at:
        # activations mode archives round(scores, digits_results), so the
        # alert comparison uses the same rounded values (else a score of
        # -1.996 vs threshold -2.0 fires an alert the archived -2.00 can
        # never confirm); detections mode thresholds the raw scores, so the
        # alert does too — mirroring whichever archive this writer produces.
        self._alert_round = digits_results if threshold is None else None
        # optional notification hook: each alert also launches the user's
        # command (event data in BUZZ_* env vars) on a bounded, non-blocking
        # dispatcher — see runtime/alert_command.py for the design rules
        self.alert_runner = None
        if alert is not None and alert_command \
                and str(alert_command).strip():
            from buzzdetect_torch.runtime.alert_command import \
                AlertCommandRunner
            self.alert_runner = AlertCommandRunner(alert_command, self.log)
        self.framehop_s = framehop_s
        # aggregate throughput accounting (audio-seconds actually landed)
        self.audio_seconds_written = 0.0
        self.chunks_written = 0
        # files with a failed chunk (results=None from the inferer's error
        # path): they must NEVER be finalized — the partial stays on disk so
        # a later run re-analyzes the hole
        self.failed_idents = set()
        # partials whose header line was verified intact this run (checked
        # once per file, on the first append that finds it already on disk)
        self._verified_partials = set()

        if threshold is None:
            def format_func(results, time_start):
                return format_activations(
                    results=results, classes=classes, framehop_s=framehop_s,
                    digits_time=digits_time, time_start=time_start,
                    classes_keep=classes_out, digits_results=digits_results)
        else:
            def format_func(results, time_start):
                return format_detections(
                    results, threshold, classes, framehop_s, digits_time,
                    time_start)
        self.format = format_func

    def __call__(self):
        self.run()

    def log(self, msg, level_str):
        self.coordinator.q_log.put(AssignLog(message=f'writer: {msg}',
                                             level_str=level_str))

    def _verify_partial(self, path_partial: str, expected_header: str) -> bool:
        """True if the partial on disk is appendable (header line intact).

        A 0-byte partial (creation torn before the header flushed) is
        treated as absent so the header is written now; a partial whose
        first line differs from the header this run writes (torn mid-header,
        or corrupted) is quarantined to ``<partial>.corrupt`` and restarted
        — its rows cannot be column-validated against a broken header.
        """
        if os.path.getsize(path_partial) == 0:
            return False
        with open(path_partial, 'r', newline='') as f:
            first = f.readline().rstrip('\r\n')
        if first == expected_header:
            return True
        from buzzdetect_torch.write.coverage import quarantine_partial
        path_corrupt = quarantine_partial(path_partial)
        self.log(f'{os.path.basename(path_partial)} has a torn or mismatched '
                 f'header line; quarantined to '
                 f'{os.path.basename(path_corrupt)} and restarting the '
                 f'partial fresh', 'WARNING')
        return False

    @staticmethod
    def _truncate_torn_tail(path_partial: str) -> str:
        """Drop a torn (newline-less) final line before appending.

        Returns the prefix the caller must prepend to its append text: ''
        after a clean tail or a successful truncation; '\\n' in the
        pathological fallback where no earlier newline exists in the file
        (e.g. a header-only partial whose header line itself lacks the
        newline — truncating would empty the file under a header the
        caller isn't going to rewrite), preserving the old glue-guard
        behavior there.
        """
        with open(path_partial, 'rb+') as f:
            size = f.seek(0, os.SEEK_END)
            f.seek(-1, os.SEEK_END)
            if f.read(1) == b'\n':
                return ''
            # a row is a few hundred bytes; 64 KiB is orders of magnitude
            # more, so the window virtually always contains the previous
            # row's newline
            window = min(size, 65536)
            f.seek(size - window)
            cut = f.read(window).rfind(b'\n')
            if cut < 0:
                return '\n'
            f.truncate(size - window + cut + 1)
        return ''

    def _emit_alerts(self, results, a_chunk: AssignChunk):
        """Log one line per (chunk, alerted class) with detected frames.

        WARNING level so an alert surfaces at every default console
        verbosity (and colored in the GUI's log pane) — the user asked for
        these by opting in. Times follow the result rows' clock
        (chunk start + frame index * framehop).
        """
        names, idxs, thr, framelength_s = self.alert
        for name, idx in zip(names, idxs):
            col = results[:, idx]
            if self._alert_round is not None:
                # float64 then round: exactly the values format_activations
                # archives
                col = np.round(np.asarray(col, dtype=np.float64),
                               self._alert_round)
            # detections mode: col stays in the scores' raw dtype so the
            # comparison is bit-identical to format_detections' (a float64
            # cast here could fire on a float32 score the archived d_ row
            # rejects, near the threshold)
            hits = np.flatnonzero(col > thr)
            if not len(hits):
                continue
            t0 = a_chunk.chunk[0] + hits[0] * self.framehop_s
            # span end = last detected frame's start + the FRAME length
            # (the audio the model actually scored) — framehop alone would
            # mis-state it whenever framehop_prop != 1
            t1 = a_chunk.chunk[0] + hits[-1] * self.framehop_s \
                + framelength_s
            peak = float(col[hits].max())
            if self._alert_round is not None:
                # the rounded value the activations archive holds
                peak_s = f'{peak:.{self.digits_results}f}'
            else:
                # detections mode compared RAW scores (like the archived d_
                # rows); print enough digits that the peak visibly exceeds
                # the threshold instead of rounding it back below — 9
                # significant digits round-trip any float32 score exactly
                peak_s = f'{peak:.9g}'
            self.coordinator.q_log.put(AssignLog(
                message=f'DETECTED {name} in {a_chunk.file.ident}: '
                        f'{len(hits)} frame(s) '
                        f'{round(t0, self.digits_time)}-'
                        f'{round(t1, self.digits_time)}s '
                        f'(peak activation {peak_s})',
                level_str='WARNING'))
            if self.alert_runner is not None:
                self.alert_runner.submit({
                    'class': name,
                    'ident': a_chunk.file.ident,
                    'audio': a_chunk.file.path_audio,
                    'start': round(t0, self.digits_time),
                    'end': round(t1, self.digits_time),
                    'frames': len(hits),
                    'peak': peak_s,
                    'threshold': thr})

    def write_results(self, a_chunk: AssignChunk, fully_analyzed: bool):
        if a_chunk.results is None:
            # inference failed (or was interrupted) for this chunk: record
            # the hole so the file is left as a resumable partial, never
            # promoted to a complete file missing data
            if a_chunk.file.ident not in self.failed_idents:
                self.failed_idents.add(a_chunk.file.ident)
                self.log(f'{a_chunk.file.shortpath_audio}: chunk '
                         f'{a_chunk.chunk} has no results; leaving the file '
                         f'as a resumable partial', 'WARNING')
        if a_chunk.results is not None:
            results = _materialize(a_chunk.results, a_chunk.n_valid)
            if self.alert is not None:
                # advisory only: an alert failure must never mark the chunk
                # failed (that would block finalization and leave a
                # resumable hole over perfectly good results)
                try:
                    self._emit_alerts(results, a_chunk)
                except Exception as e:
                    self.log(f'alert emission failed for '
                             f'{a_chunk.file.shortpath_audio}: {e} '
                             f'(results unaffected)', 'WARNING')
            table = self.format(results=results, time_start=a_chunk.chunk[0])

            path_partial = a_chunk.file.path_results_partial
            os.makedirs(os.path.dirname(path_partial) or '.', exist_ok=True)
            file_exists = os.path.exists(path_partial)
            if file_exists and path_partial not in self._verified_partials:
                # a SIGKILL can tear the very first append mid-header (or
                # before any byte flushed): appending data rows under a
                # torn header poisons the file — every row mismatches the
                # header's column count, reads as torn, and finalization
                # would promote an empty result. Verify once per file.
                file_exists = self._verify_partial(path_partial,
                                                   table.header())
            self._verified_partials.add(path_partial)
            text = table.render_csv(self.digits_time,
                                    include_header=not file_exists)
            if file_exists and os.path.getsize(path_partial) > 0:
                # a SIGKILL-torn previous append may have left the file
                # without a trailing newline. TRUNCATE the torn line before
                # appending: appending directly would glue it to this
                # table's FIRST row, and merely prepending '\n' would
                # launder a parseable-torn tear ('19.2,0.53' torn to
                # '19.2,0.5' — right column count, every cell parses) into
                # a newline-terminated row that survives to finalization
                # with the corrupt value. Truncation loses nothing: the
                # torn frame's span was subtracted from resume coverage
                # (read_result_rows torn_starts), so its replacement row is
                # already scheduled.
                text = self._truncate_torn_tail(path_partial) + text
            with open(path_partial, 'a', newline='') as f:
                f.write(text)
            seconds = a_chunk.chunk[1] - a_chunk.chunk[0]
            self.audio_seconds_written += seconds
            self.chunks_written += 1
            self.coordinator.record_written(seconds)

        if (fully_analyzed
                and a_chunk.file.ident not in self.failed_idents
                and not self.coordinator.stream_failed(a_chunk.file.ident)
                and os.path.exists(a_chunk.file.path_results_partial)):
            finalize_partial(a_chunk.file.path_results_partial,
                             a_chunk.file.path_results_complete)
            self.coordinator.record_finalized()
            self.log(f'finalized {a_chunk.file.shortpath_results_complete}',
                     'DEBUG')

    def run(self):
        try:
            self._run()
        except Exception as e:
            # per-chunk write errors are contained in the loop; a fatal
            # writer death means results would silently stop landing —
            # stop the run loudly instead of analyzing into the void
            import traceback
            from buzzdetect_torch.runtime.coordination import ExitSignal
            # fully reported through the log channel (incl. traceback);
            # re-raising into the thread excepthook would only double-print
            self.coordinator.exit_analysis(ExitSignal(
                message=f'writer failed fatally: {e}; stopping analysis '
                        f'(finished chunks are checkpointed)\n'
                        f'{traceback.format_exc()}',
                level='ERROR', end_reason='writer failure'))
        finally:
            if self.alert_runner is not None:
                # in the finally so a FATAL writer death still ships/
                # summarizes notifications (bounded drain: queued alerts
                # for the final chunks go out, a hung command is abandoned
                # to its own kill timeout, drops/failures land in the log)
                try:
                    self.alert_runner.close()
                except Exception:
                    pass  # never let notification teardown mask the exit
                # hand the counters to the coordinator for the
                # machine-readable run summary (the log lines above are
                # the human copy). stats() snapshots under the runner's
                # lock and flags the one case where a count can still
                # move — an abandoned in-flight command resolving on the
                # daemon thread after close returned ('final': False).
                self.coordinator.alert_stats = self.alert_runner.stats()
            self.coordinator.worker_exited('writer')

    def _run(self):
        self.log('launching', 'INFO')
        while True:
            item = self.coordinator.get_write()
            if item == 'exit':
                break
            a_chunk, fully_analyzed = item
            try:
                self.write_results(a_chunk, fully_analyzed)
            except Exception as e:
                # a failed append is a hole: the file must stay a partial
                self.failed_idents.add(a_chunk.file.ident)
                self.log(f'error writing {a_chunk.file.shortpath_audio}: {e}; '
                         f'leaving the file as a resumable partial', 'ERROR')
        self.log(f'wrote {self.chunks_written} chunks, '
                 f'{self.audio_seconds_written:,.0f} audio-seconds', 'DEBUG')
        self.log('terminating', 'DEBUG')
