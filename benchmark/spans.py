"""The program's own spans in a traced run (``buzzdetect.*``, from
``buzzdetect_torch/runtime/spans.py``), and the device time each launched.

A ``torch.profiler`` session saves its trace once, and ``benchmark/trace.py``
has saved and read it by the time a reader runs. So ``of(run)`` reads the
same session's events in memory (``kineto_results.events()``: the same
names, times, thread ids and CUDA correlation ids as the export), puts the
ones read here into the Chrome trace's shape (``chrome_events``), and keeps
the result on ``run``. ``Spans`` reads events of that shape:

* a chunk is in the window if its ``buzzdetect.dispatch`` starts inside
  ``bench.active``; the closed loop drains at both edges, so the device
  work of those chunks lies inside the window too. Every per-chunk number
  here divides by the count of those spans;
* a span counts if it lies inside a window chunk's dispatch, on the same
  thread;
* a kernel, copy or set belongs to a span if the CUDA runtime call that
  launched it (the ``cuda_runtime`` event with its ``correlation``) lies
  inside the span on the same thread. Device time is never given to a span
  by a kernel's name or by overlap in time: the dispatch threads'
  streams interleave.

A program without the spans gives no chunks, and every reader None.
"""

import bisect
import collections
import sys

from benchmark.trace import MARK, _union

DISPATCH = 'buzzdetect.dispatch'
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


def chrome_events(prof):
    """The user ranges, CUDA runtime calls and device operations of the
    stopped session ``prof`` (``torch.profiler.profile``), each as the
    Chrome export writes it (times in microseconds from the session's
    start, ``tid`` the system thread or the stream)."""
    import torch
    cpu = torch.autograd.DeviceType.CPU
    results = prof.profiler.kineto_results
    t0 = results.trace_start_ns()
    out = []
    for e in results.events():
        name, on_cpu = e.name(), e.device_type() == cpu
        if e.is_user_annotation():
            if not on_cpu:          # the range's copy on the device's rows
                continue
            cat = 'user_annotation'
        elif on_cpu:
            if not name.startswith('cu'):      # torch's operators
                continue
            cat = 'cuda_runtime'
        else:
            cat = ('gpu_memcpy' if name.startswith('Memcpy') else
                   'gpu_memset' if name.startswith('Memset') else 'kernel')
        out.append({'ph': 'X', 'cat': cat, 'name': name,
                    'tid': e.device_resource_id(),
                    'ts': (e.start_ns() - t0) / 1e3,
                    'dur': e.duration_ns() / 1e3,
                    'args': {'correlation': e.correlation_id()}})
    return out


class Spans:
    """The window's chunks and their spans, from Chrome trace events."""

    def __init__(self, events):
        ranges = collections.defaultdict(list)     # name -> (tid, a, b)
        self.runtime = {}                           # correlation -> (tid, t)
        self.device = []                            # (correlation, dur)
        marks = []
        for e in events:
            if e.get('ph') != 'X' or 'dur' not in e:
                continue
            cat, a = e.get('cat'), float(e['ts'])
            if cat == 'user_annotation':
                if e['name'] == MARK:
                    marks.append((float(e['dur']), a))
                elif e['name'].startswith('buzzdetect.'):
                    ranges[e['name']].append((e['tid'], a,
                                              a + float(e['dur'])))
            elif cat == 'cuda_runtime':
                self.runtime[e['args']['correlation']] = (e['tid'], a)
            elif cat in DEVICE_CATS:
                self.device.append((e['args'].get('correlation'),
                                    float(e['dur'])))
        self.ranges = ranges
        self._dispatch = {}                # tid -> sorted window dispatches
        if not marks:
            self.chunks = 0
            return
        dur, t0 = max(marks)
        inside = sorted((tid, a, b) for tid, a, b in ranges[DISPATCH]
                        if t0 <= a <= t0 + dur)
        self.chunks = len(inside)
        for tid, a, b in inside:
            self._dispatch.setdefault(tid, []).append((a, b))

    @staticmethod
    def _holds(table, tid, t):
        """True if one of ``table[tid]``'s sorted (start, end) intervals
        holds ``t``."""
        rows = table.get(tid)
        if not rows:
            return False
        i = bisect.bisect_right(rows, (t, float('inf'))) - 1
        return i >= 0 and rows[i][0] <= t <= rows[i][1]

    def spans(self, name):
        """(tid, start, end) of each ``name`` span of a window chunk."""
        return [s for s in self.ranges.get(name, ())
                if self._holds(self._dispatch, s[0], s[1])]

    def host_s(self, names) -> float:
        """Host seconds inside the window chunks' spans of ``names``, a
        stretch covered by two of them counted once."""
        by_tid = collections.defaultdict(list)
        for name in names:
            for tid, a, b in self.spans(name):
                by_tid[tid].append((a, b))
        return sum(b - a for v in by_tid.values()
                   for a, b in _union(v)) / 1e6

    def device_s(self, name) -> float:
        """Device seconds of the kernels, copies and sets whose launching
        runtime call lies inside a window chunk's ``name`` span, on the
        launching thread."""
        table = collections.defaultdict(list)
        for tid, a, b in self.spans(name):
            table[tid].append((a, b))
        for rows in table.values():
            rows.sort()
        total = 0.0
        for corr, dur in self.device:
            call = self.runtime.get(corr)
            if call is not None and self._holds(table, *call):
                total += dur
        return total / 1e6


def of(run):
    """The traced run's ``Spans``, read once and kept on ``run``; None for
    an untraced run."""
    if getattr(run, 'spans', None) is None:
        prof = getattr(run.tracer, '_prof', None)
        if prof is None:
            return None
        run.spans = Spans(chrome_events(prof))
        print(f'spans: {run.spans.chunks} chunks dispatched in the traced '
              f'window; the closed loop counted '
              f'{run.outcome.get("trace_chunks")}', file=sys.stderr)
    return run.spans


def per_chunk_ms(run, names):
    """Host milliseconds a window chunk spends in the spans of ``names``,
    or None where the trace holds no chunk."""
    s = of(run)
    if s is None or not s.chunks:
        return None
    return 1e3 * s.host_s(names) / s.chunks
