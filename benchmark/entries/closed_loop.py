"""Closed loop over the pipeline's per-chunk path.

``dispatchers`` threads (the pipeline's dispatch threads, one per analyzer
on the card), each on a CUDA stream of its own as ``runtime/inferer``
gives it, send the chunks round, ``in_flight`` chunks at a time each:
dispatch chunk n + 1 (``predict_async`` on the streamer's wire buffer, its
copy back started at once), then wait for chunk n's scores in host memory
(what the inferer and the writer do). ``stream_rtf`` is the audio of every
chunk whose scores reached host memory inside the window, over the window.

Traced run: at ``trace_after`` of the window every dispatcher drains, the
profiler starts, ``trace_lead`` later they drain again and the traced
window opens for ``trace_seconds``, then they drain once more before it
closes; every chunk dispatched in it ran inside it.
"""

import collections
import sys
import threading
import time

import numpy as np

from benchmark import checks, program

WARM_ROUNDS = 2


class Loop:
    """One dispatch thread's closed loop."""

    def __init__(self, model, chunks, in_flight, offset=0):
        self.model, self.chunks, self.in_flight = model, chunks, in_flight
        self.pending = collections.deque()
        self.done = []          # (chunk, completion time, scores)
        self.dispatched = offset
        self.count = 0
        self.host_s = []        # each dispatch's host time

    def until(self, t_end, count=None):
        """Dispatch until ``t_end`` (or ``count`` chunks), closed loop."""
        stop = self.count + count if count is not None else None
        while (time.perf_counter() < t_end if stop is None
               else self.count < stop):
            k = self.dispatched % len(self.chunks)
            t = time.perf_counter()
            self.pending.append((k, program.dispatch(self.model,
                                                     self.chunks[k])))
            self.host_s.append(time.perf_counter() - t)
            self.dispatched += 1
            self.count += 1
            if len(self.pending) >= self.in_flight:
                self._complete()

    def drain(self):
        while self.pending:
            self._complete()

    def _complete(self):
        k, copy = self.pending.popleft()
        out = program.collect(*copy)
        self.done.append((k, time.perf_counter(), out))

    def phases(self, ends, barrier):
        """Run to each of ``ends`` in turn, draining at each; at every end
        but the last, meet the others at ``barrier`` twice (while the
        caller acts between)."""
        with program.dispatch_scope(self.model):
            for i, t_end in enumerate(ends):
                self.until(t_end)
                self.drain()
                if i < len(ends) - 1:
                    barrier.wait()
                    barrier.wait()


def setup(run):
    chunks = run.generate()['chunks']
    model = program.load_model(run.config, run.device)
    run.mark('model loaded')
    warm = Loop(model, chunks, run.params['in_flight'])
    with program.dispatch_scope(model):
        warm.until(None, count=1)
        warm.drain()
        run.mark('first chunk')
        warm.until(None, count=WARM_ROUNDS * len(chunks))
        warm.drain()
    run.sync()
    run.mark('warm')
    return {'model': model, 'chunks': chunks}


def window(run, st):
    n = run.params['dispatchers']
    chunks = st['chunks']
    loops = [Loop(st['model'], chunks, run.params['in_flight'],
                  offset=i * len(chunks) // n)
             for i in range(n)]
    t0 = time.perf_counter()
    t_end = t0 + run.seconds
    traced = {}
    if run.tracer is None:
        ends, barrier, acts = [t_end], None, []
    else:
        t_a = t0 + run.params['trace_after'] * run.seconds
        t_b = t_a + run.params['trace_lead']
        t_c = t_b + run.params['trace_seconds']
        ends, barrier = [t_a, t_b, t_c, t_end], threading.Barrier(n + 1)

        def opened():
            run.tracer.open()
            traced['n0'] = sum(lp.count for lp in loops)

        def closed():
            run.tracer.close()
            run.tracer.stop()
            traced['trace_chunks'] = sum(lp.count for lp in loops) \
                - traced.pop('n0')
        acts = [run.tracer.start, opened, closed]
    threads = [threading.Thread(target=lp.phases, args=(ends, barrier),
                                name=f'bench_dispatch_{i}')
               for i, lp in enumerate(loops)]
    for t in threads:
        t.start()
    for act in acts:
        barrier.wait()
        act()
        barrier.wait()
    for t in threads:
        t.join()
    done = [d for lp in loops for d in lp.done]
    in_window = sum(1 for _k, t, _o in done if t <= t_end)
    seconds = len(chunks[0]) / run.sample_rate
    st['outputs'] = [(k, out) for k, _t, out in done]
    host = np.array([h for lp in loops for h in lp.host_s]) * 1e3
    per_s = np.histogram([t - t0 for _k, t, _o in done],
                         bins=int(run.seconds), range=(0, int(run.seconds)))[0]
    dispatched = sum(lp.count for lp in loops)
    print(f'closed loop: {dispatched} chunks from {n} dispatchers; host ms '
          f'a dispatch p50 {np.median(host):.4f}, p95 '
          f'{np.percentile(host, 95):.4f}; chunks a second '
          f'{" ".join(map(str, per_s))}', file=sys.stderr)
    return dict(traced, window_s=t_end - t0, audio_s=in_window * seconds,
                host_dispatch_s=float(host.sum()) / 1e3,
                completed=in_window, attempted=dispatched,
                failed=dispatched - len(done), chunk_samples=len(chunks[0]))


def release(st):
    del st['model']


def check(run, st, outcome):
    keys = sorted({k for k, _o in st['outputs']})
    refs = run.reference({k: st['chunks'][k] for k in keys})
    return checks.answer_checks(st['outputs'], refs, run.limits,
                                outcome['attempted'])
