"""Analysis window: runs an analysis in a child process, streams its log
records into a colored textbox, and offers stop/rerun.

Parity: reference `src/gui/analysis.py:12-242` — the analysis runs in a
``multiprocessing.Process`` (the only process boundary in the system) so the
GUI stays responsive and a stop can always be delivered; log records arrive
over ``q_gui`` and are drained every POLL_INTERVAL_MS.

Copy of ``buzzdetect_tpu/gui/analysis.py``, import prefix changed: the
child runs the port's ``analyze()`` on the form's ``device`` (``'cuda'``
unless the form says ``'cpu'``), still in a ``spawn`` child, which CUDA
needs (a forked child cannot initialise CUDA).
"""

import multiprocessing
import queue as queue_mod
import tkinter as tk
from tkinter import messagebox, ttk

from buzzdetect_torch.gui import config as gui_cfg


def run_analysis(kwargs, q_gui, event_stop):
    """Child-process entry point: run analyze() with GUI hooks attached.

    Failures raised BEFORE the logger worker exists (model load, threshold
    calibration, bad kwargs) would otherwise die on the child's stderr with
    the window showing nothing — forward them to the GUI queue directly."""
    try:
        # the import itself is the most common pre-logger failure in a
        # packaged build (jax/native-lib load errors) — it must be inside
        # the try or the window stays blank with no explanation
        from buzzdetect_torch.analysis import analyze
        analyze(q_gui=q_gui, event_stopanalysis=event_stop, **kwargs)
    except BaseException as e:
        import traceback
        try:
            from buzzdetect_torch.runtime.assignments import AssignLog
            record = AssignLog(message='', level_str='ERROR')
        except Exception:  # even the record class may be unimportable
            import types
            record = types.SimpleNamespace(message='', level_str='ERROR',
                                           terminate=False)
        record.message = f'analysis failed: {e}\n{traceback.format_exc()}'
        q_gui.put(record)
        raise


class AnalysisWindow(tk.Toplevel):
    def __init__(self, parent, analyze_kwargs):
        super().__init__(parent)
        self.title('buzzdetect — analysis')
        self.geometry('900x520')
        self.analyze_kwargs = analyze_kwargs

        self.textbox = tk.Text(self, bg='#1a1a1a', state='disabled',
                               wrap='word')
        self.textbox.pack(fill='both', expand=True, padx=8, pady=8)
        for level, color in gui_cfg.LEVEL_COLORS.items():
            self.textbox.tag_configure(level, foreground=color)

        bar = ttk.Frame(self)
        bar.pack(fill='x', padx=8, pady=(0, 8))
        self.btn_stop = ttk.Button(bar, text='Stop analysis',
                                   command=self.stop_analysis)
        self.btn_stop.pack(side='left')
        self.btn_rerun = ttk.Button(bar, text='Rerun', state='disabled',
                                    command=self.launch_analysis)
        self.btn_rerun.pack(side='left', padx=8)

        self.process = None
        self.q_gui = None
        self.event_stop = None
        self._poll_handle = None
        self._dead_polls = 0
        self.protocol('WM_DELETE_WINDOW', self._on_close)
        self.launch_analysis()

    # --- process lifecycle ---------------------------------------------------
    def launch_analysis(self):
        import time
        self._launched_at = time.time()
        ctx = multiprocessing.get_context('spawn')
        self.q_gui = ctx.Queue()
        self.event_stop = ctx.Event()
        self.process = ctx.Process(
            target=run_analysis,
            args=(self.analyze_kwargs, self.q_gui, self.event_stop),
            daemon=True)
        self.process.start()
        self.btn_stop.configure(state='normal')
        self.btn_rerun.configure(state='disabled')
        self._dead_polls = 0
        self._poll_handle = self.after(gui_cfg.POLL_INTERVAL_MS,
                                       self.poll_queue)

    def stop_analysis(self):
        if self.process is None or not self.process.is_alive():
            return
        if messagebox.askyesno('Stop analysis',
                               'Stop the running analysis? Finished chunks '
                               'are saved and the run can be resumed later.'):
            self.event_stop.set()

    def _on_close(self):
        """Closing the window must stop the analysis (its chunks checkpoint,
        so the run resumes later) and cancel the pending poll — otherwise
        the child keeps running headless and the scheduled callback fires
        on destroyed widgets."""
        if self.process is not None and self.process.is_alive():
            if not messagebox.askyesno(
                    'Close window',
                    'An analysis is running. Stop it and close? Finished '
                    'chunks are saved and the run can be resumed later.'):
                return
            self.event_stop.set()
            # keep draining q_gui while waiting: a child with a large
            # undrained log backlog blocks on the full queue pipe at exit
            # and would otherwise always hit the timeout and be terminated
            import time
            deadline = time.monotonic() + 15
            while self.process.is_alive() and time.monotonic() < deadline:
                try:
                    while True:
                        self.q_gui.get_nowait()
                except queue_mod.Empty:
                    pass
                except Exception:
                    # a child dying mid-pipe-write leaves a truncated
                    # pickle (EOFError/UnpicklingError, not Empty) — same
                    # defense as poll_queue; letting it escape the Tk
                    # callback would skip terminate/destroy and wedge the
                    # window half-closed
                    pass
                self.process.join(timeout=0.2)
            if self.process.is_alive():
                self.process.terminate()
        if self._poll_handle is not None:
            self.after_cancel(self._poll_handle)
            self._poll_handle = None
        self.destroy()

    # --- log streaming ----------------------------------------------------------
    def poll_queue(self):
        self._poll_handle = None
        drained = 0
        try:
            while True:
                a_log = self.q_gui.get_nowait()
                self._append(a_log)
                drained += 1
        except queue_mod.Empty:
            pass
        except Exception as e:
            # a child killed mid-pipe-write can leave a truncated pickle in
            # the queue (EOFError/UnpicklingError, not Empty); letting it
            # escape the Tk callback would never re-arm the poll and wedge
            # the window with Stop enabled forever
            from buzzdetect_torch.runtime.assignments import AssignLog
            self._append(AssignLog(
                message=f'[gui] log stream broke: {type(e).__name__}: {e}',
                level_str='WARNING'))
        if (self.process is not None and self.process.is_alive()) \
                or drained > 0:
            self._dead_polls = 0
        else:
            # the child exited, but its final records (summary, traceback)
            # may still be unpickled bytes in the queue's pipe buffer —
            # keep polling until it stays empty for a few cycles
            self._dead_polls += 1
            if self._dead_polls > 3:
                self._append_outcome()
                self.btn_stop.configure(state='disabled')
                self.btn_rerun.configure(state='normal')
                return
        self._poll_handle = self.after(gui_cfg.POLL_INTERVAL_MS,
                                       self.poll_queue)

    def _append_outcome(self):
        """One structured line once the child is done: the run summary's
        outcome, colored by its ok flag — after a long run the decisive
        log lines are buried under thousands of PROGRESS rows, and a
        child that died without logging (OOM-killed) leaves the box
        trailing off mid-progress with no verdict at all."""
        import json
        import os

        from buzzdetect_torch import config as cfg
        # a blank dir_out field is legal (OPTIONAL_EMPTY_FIELDS): the
        # child resolves the model's default output folder and writes its
        # summary THERE — resolve with the same one-definition rule
        # (config.resolve_dir_out) or the outcome line is dead exactly in
        # the GUI's zero-config path
        dir_out = cfg.resolve_dir_out(self.analyze_kwargs.get('dir_out'),
                                      self.analyze_kwargs.get('modelname'))
        try:
            with open(os.path.join(dir_out, cfg.FNAME_RUN_SUMMARY)) as f:
                s = json.load(f)
        except Exception:
            return  # pre-run crash: its traceback is already in the box
        # a summary written by a DIFFERENT process is not this run's
        # outcome: a lock-refused child deliberately writes nothing, so
        # the file is the live OWNER's — reporting its 'running' marker
        # here would claim our child was killed, contradicting the
        # refusal message right above it
        spid = s.get('pid')
        if (spid is not None and self.process is not None
                and spid != self.process.pid):
            return
        try:
            # a child that crashed BEFORE the Analyzer existed wrote no
            # marker; the file then belongs to a PREVIOUS attempt and
            # reporting it as this run's outcome would contradict the
            # traceback above it (5 s slack: the summary stamps its
            # 'started' at Analyzer init, shortly after process spawn)
            from datetime import datetime
            started = datetime.fromisoformat(s['started']).timestamp()
            if started < self._launched_at - 5:
                return
        except (KeyError, ValueError, TypeError):
            pass  # unparseable: report rather than silently drop
        from buzzdetect_torch.runtime.assignments import AssignLog
        failed = s.get('files_failed') or []
        if s.get('end_reason') == 'running':
            # the start-of-run marker was never replaced: the child died
            # without reaching any end path (killed, OOM)
            msg = ('[run summary] the analysis process exited without '
                   'finishing (killed?); finished chunks are saved — '
                   'rerun to resume')
            level = 'ERROR'
        else:
            level = ('WARNING' if failed else 'INFO') if s.get('ok') \
                else 'ERROR'
            names = ', '.join(failed[:5]) + (', ...' if len(failed) > 5
                                             else '')
            msg = (f"[run summary] {s.get('end_reason')}: "
                   f"{s.get('files_finalized', 0)} file(s) finalized, "
                   f"{len(failed)} failed"
                   + (f' ({names})' if failed else '')
                   + f"; {s.get('audio_seconds', 0):,.0f} audio-seconds "
                     f"at {s.get('rate_realtime', 0):g}x realtime")
        self._append(AssignLog(message=msg, level_str=level))

    def _append(self, a_log):
        self.textbox.configure(state='normal')
        self.textbox.insert('end', a_log.message + '\n', a_log.level_str)
        self.textbox.see('end')
        self.textbox.configure(state='disabled')
