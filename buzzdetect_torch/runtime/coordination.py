"""Pipeline coordinator: queues, per-file completion tracking, exit protocol.

Architecture parity with the reference coordinator
(`src/pipeline/coordination.py:26-196`), which is a sound design worth
keeping: the coordinator is the *single owner* of exit. Workers never poll a
flag; they block on queue getters and stop when they receive an EXIT
sentinel. On teardown (normal or early) the coordinator "poisons" each queue
with one sentinel per consumer so every blocked `get()` wakes exactly once.

Completion detection is exact: a per-file tracker records chunks in flight;
the writer finalizes a file when its last chunk lands AND its stream is done.

TPU adaptations: the bounded q_analyze is the host-side prefetch ring in
front of the device (its depth bounds host RAM at roughly
depth x chunklength x 2 bytes (int16 wire format)); worker sizing defaults reflect one XLA
device fed by many GIL-free decode threads.
"""

import os
import queue
import threading

from buzzdetect_torch.runtime.assignments import AssignChunk, AssignLog

EXIT = 'exit'

# End reasons that mean the run finished the work it was given (as opposed
# to interrupts, worker failures, stalls, or configuration refusals). The
# SINGLE source of truth: the watch loop keys re-watching off it and the
# CLI keys its exit code off it — a reason added to one copy but not the
# other would break `buzzdetect ... && next_step` supervisor pipelines.
HEALTHY_END_REASONS = ('completed', 'fully analyzed', 'no files')


class ExitSignal:
    def __init__(self, message, level, end_reason):
        self.message = message
        self.level = level
        self.end_reason = end_reason


class StreamTracker:
    __slots__ = ('chunks_streamed', 'stream_in_progress')

    def __init__(self):
        self.chunks_streamed = []
        self.stream_in_progress = True


class Coordinator:
    def __init__(self,
                 analyzers_cpu: int = 1,
                 analyzers_gpu: int = 0,
                 streamers_total: int = None,
                 depth: int = None,
                 q_gui=None,
                 event_analysisdone=None,
                 q_earlyexit=None):
        self.analyzers_cpu = analyzers_cpu
        self.analyzers_gpu = analyzers_gpu
        self.analyzers_total = analyzers_cpu + analyzers_gpu
        self.streamers_total = (self._default_streamers()
                                if streamers_total is None else streamers_total)
        self.queue_depth = (self.streamers_total * 2
                            if depth is None else depth)
        # 0/negative sizing is always a mistake: queue.Queue(maxsize=0) is
        # UNBOUNDED (silently removing the documented host-RAM bound) and
        # zero workers makes a no-op run report 'Analysis complete'
        if self.analyzers_total < 1:
            raise ValueError('need at least one analyzer '
                             '(analyzers_cpu + analyzers_gpu >= 1)')
        if self.streamers_total < 1:
            raise ValueError('n_streamers must be >= 1')
        if self.queue_depth < 1:
            raise ValueError('stream_buffer_depth must be >= 1')
        self.q_gui = q_gui

        self.assigned_chunks = {}
        self.failed_streams = set()
        self._lock = threading.Lock()
        self._exit_lock = threading.Lock()

        self.q_log = queue.Queue()
        self.q_stream = queue.Queue()
        self.q_analyze = queue.Queue(maxsize=self.queue_depth)
        # q_write is ALSO bounded: results on it are un-materialized device
        # futures, so its depth is the device-side in-flight window. Unbounded,
        # the inferer dispatches the whole backlog and the queued host->device
        # uploads delay the first result's download for minutes (observed on
        # bandwidth-limited links); bounded, dispatch stays a few chunks ahead
        # of the writer — full overlap, no flooding, prompt checkpoints.
        self.q_write = queue.Queue(maxsize=max(4, 4 * self.analyzers_total))

        # set when the LAST worker of each stage has exited its run loop.
        # The workers themselves signal via worker_exited() — these events
        # gate put_write's and _poison's bail-outs, which would be
        # unreachable (early-exit livelock: an analyzer spinning put_write
        # against a consumer-less full q_write) if only wait_for_exit's
        # watcher set them after joining those very workers.
        self.streamers_done = threading.Event()
        self.analyzers_done = threading.Event()
        self.writer_done = threading.Event()
        self._workers_alive = {'streamer': self.streamers_total,
                               'analyzer': self.analyzers_total,
                               'writer': 1}
        self._done_events = {'streamer': self.streamers_done,
                             'analyzer': self.analyzers_done,
                             'writer': self.writer_done}

        # external-stop hooks (multiprocessing primitives when run under a GUI)
        self.event_exitanalysis = (event_analysisdone
                                   if event_analysisdone is not None
                                   else threading.Event())
        self.q_earlyexit = q_earlyexit if q_earlyexit is not None else queue.Queue()

        self.end_reason = None
        self.chunks_done = 0
        self.files_finalized = 0
        # set once by the writer at alert-runner close (final counters);
        # None when the run had no alert_command
        self.alert_stats = None
        # aggregate progress (audio-seconds landed in result files)
        self.audio_seconds_done = 0.0

    def _default_streamers(self):
        # decode must outrun the device: GIL-free native decode scales with
        # cores, so default to a healthy pool per inferer
        n_cpu = os.cpu_count() or 4
        return max(2, min(4 * self.analyzers_total, n_cpu))

    def log(self, msg, level_str):
        self.q_log.put(AssignLog(message=f'coordinator: {msg}',
                                 level_str=level_str))

    # --- worker-facing queue API ------------------------------------------
    def get_stream(self):
        return self.q_stream.get()

    def put_analyze(self, a_chunk: AssignChunk):
        with self._lock:
            tracker = self.assigned_chunks.setdefault(a_chunk.file.ident,
                                                      StreamTracker())
            tracker.chunks_streamed.append(a_chunk.chunk)
            if a_chunk.last_chunk:
                tracker.stream_in_progress = False

        # bounded queue: block with a timeout so an exit request can't
        # deadlock a streamer against a full queue. Also bail when every
        # analyzer has exited — during normal completion that can only
        # happen after the streamers are already done, so this fires only
        # when the consumers died abnormally and nobody will ever drain
        while True:
            if (self.event_exitanalysis.is_set()
                    or self.analyzers_done.is_set()):
                return
            try:
                self.q_analyze.put(a_chunk, timeout=1)
                return
            except queue.Full:
                continue

    def get_analyze(self):
        return self.q_analyze.get()

    def put_write(self, a_chunk: AssignChunk):
        # bounded queue: during an interrupted shutdown the writer may have
        # already exited on its sentinel — don't deadlock against it
        while True:
            if self.writer_done.is_set():
                return
            try:
                self.q_write.put(a_chunk, timeout=0.5)
                return
            except queue.Full:
                continue

    def get_write(self):
        a_chunk = self.q_write.get()
        if a_chunk == EXIT:
            return EXIT
        with self._lock:
            tracker = self.assigned_chunks[a_chunk.file.ident]
            tracker.chunks_streamed.remove(a_chunk.chunk)
            fully_analyzed = (not tracker.chunks_streamed
                              and not tracker.stream_in_progress)
        return a_chunk, fully_analyzed

    def worker_exited(self, kind: str):
        """Called by each worker as its run loop ends; the last exit of a
        stage sets that stage's done event."""
        with self._lock:
            self._workers_alive[kind] -= 1
            if self._workers_alive[kind] <= 0:
                self._done_events[kind].set()

    def record_written(self, seconds: float):
        with self._lock:
            self.audio_seconds_done += seconds
            self.chunks_done += 1

    def record_finalized(self):
        """Writer promoted one partial to a complete result this run
        (feeds the machine-readable run summary's files_finalized)."""
        with self._lock:
            self.files_finalized += 1

    def mark_stream_finished(self, ident: str):
        """Called by a streamer that ends a file without a final chunk
        (e.g. exit mid-file), so completion tracking stays consistent."""
        with self._lock:
            tracker = self.assigned_chunks.setdefault(ident, StreamTracker())
            tracker.stream_in_progress = False

    def mark_stream_failed(self, ident: str):
        """A streamer aborted this file with chunks possibly missing (an
        unexpected decode/IO error mid-file): the writer must never promote
        it to a complete result — already-analyzed chunks checkpoint into
        the partial, and a later run re-analyzes the hole."""
        with self._lock:
            self.failed_streams.add(ident)
        self.mark_stream_finished(ident)

    def stream_failed(self, ident: str) -> bool:
        with self._lock:
            return ident in self.failed_streams

    def failed_streams_snapshot(self):
        """Sorted copy under the lock — the run summary reads this while
        streamers may still be draining (early exit returns before their
        joins), and iterating the live set concurrently with an add()
        raises 'Set changed size during iteration'."""
        with self._lock:
            return sorted(self.failed_streams)

    # --- exit protocol -----------------------------------------------------
    def _poison(self, q, n, consumers_done=None):
        """Enqueue n EXIT sentinels. For bounded queues the put can block
        when the consumer already exited on an earlier sentinel with a
        backlog left behind — bail out once ``consumers_done`` is set."""
        sent = 0
        while sent < n:
            if consumers_done is not None and consumers_done.is_set():
                return
            try:
                q.put(EXIT, timeout=0.5)
                sent += 1
            except queue.Full:
                continue

    def exit_analysis(self, exit_signal: ExitSignal):
        """First caller wins; sets the exit event every worker checks."""
        with self._exit_lock:
            if self.end_reason is not None:
                return
            self.q_log.put(AssignLog(message=exit_signal.message,
                                     level_str=exit_signal.level))
            self.end_reason = exit_signal.end_reason
            self.event_exitanalysis.set()
            # Release the early-exit watcher regardless of which channel
            # triggered the exit, so no daemon thread stays blocked on
            # q_earlyexit.get() after analyze() returns. If the exit
            # originated from q_earlyexit itself the sentinel is a harmless
            # leftover in an already-abandoned queue.
            self.q_earlyexit.put(EXIT)

    def poison_all(self, streamers=None, analyzers=None, writer=None):
        """Wake every blocked worker with EXIT sentinels. Idempotent and
        over-poison-safe (workers take one sentinel each and exit;
        leftovers sit in abandoned queues; _poison bails once a stage's
        consumers are done). Callable from OUTSIDE wait_for_exit: a
        KeyboardInterrupt can land after the workers launch but before
        wait_for_exit starts its watcher threads, and exit_analysis alone
        only sets the event — a writer blocked on q_write.get() (no
        timeout) would never wake, leaving its queued chunks undrained.

        The optional counts say how many workers of each stage actually
        LAUNCHED (None = all of them). A caller interrupted mid-launch
        must pass them: a stage with zero launched consumers never sets
        its done-event and never drains, so poisoning its bounded queue
        with more sentinels than capacity would spin ``_poison``'s
        put-retry loop forever — hanging the orderly-stop path it exists
        to serve. Never-launched workers need no waking."""
        n_s = self.streamers_total if streamers is None else streamers
        n_a = self.analyzers_total if analyzers is None else analyzers
        n_w = 1 if writer is None else writer
        if n_s:
            self._poison(self.q_stream, n_s,
                         consumers_done=self.streamers_done)
        if n_a:
            self._poison(self.q_analyze, n_a,
                         consumers_done=self.analyzers_done)
        if n_w:
            self._poison(self.q_write, n_w, consumers_done=self.writer_done)

    def wait_for_exit(self, threads_streamers, threads_analyzers,
                      thread_writer):
        def watch_workers():
            for t in threads_streamers:
                t.join()
            self.log('streamers done', 'DEBUG')
            self.streamers_done.set()
            self._poison(self.q_analyze, self.analyzers_total,
                         consumers_done=self.analyzers_done)

            for t in threads_analyzers:
                t.join()
            self.log('analyzers done', 'DEBUG')
            self.analyzers_done.set()
            self._poison(self.q_write, 1, consumers_done=self.writer_done)

            thread_writer.join()
            self.log('writer done', 'DEBUG')
            self.writer_done.set()

            self.exit_analysis(ExitSignal(message='Analysis complete',
                                          level='INFO',
                                          end_reason='completed'))

        poison_all = self.poison_all

        def watch_earlyexit():
            # message-based stop channel (used by embedding front-ends)
            exit_message = self.q_earlyexit.get()
            if exit_message == EXIT:
                return  # internal release on normal completion
            self.exit_analysis(ExitSignal(message=str(exit_message),
                                          level='WARNING',
                                          end_reason='interrupted'))
            poison_all()

        def watch_event():
            # event-based stop channel (GUI stop button, external killers):
            # when the event fires before natural completion, wake every
            # blocked worker so shutdown is prompt
            self.event_exitanalysis.wait()
            if self.end_reason is None:
                self.exit_analysis(ExitSignal(
                    message='analysis stopped by external request',
                    level='WARNING', end_reason='interrupted'))
            if self.end_reason != 'completed':
                poison_all()

        threading.Thread(target=watch_workers, daemon=True,
                         name='watch_workers').start()
        threading.Thread(target=watch_earlyexit, daemon=True,
                         name='watch_earlyexit').start()
        threading.Thread(target=watch_event, daemon=True,
                         name='watch_event').start()
        self.event_exitanalysis.wait()
        # NOTE: on an early exit this returns while workers may still be
        # draining (on completion watch_workers joined them all first) —
        # deliberately, so a wedged worker can never hang the stop
        # (test_watcher_threads_exit_after_early_stop pins this contract).
        # The caller (analysis._run) joins the WRITER before returning to
        # the user: that is the one worker whose lingering appends could
        # interleave with a rerun's writer on the same partials.
