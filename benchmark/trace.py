"""The device trace of a traced run.

``Tracer`` opens ``torch.profiler`` (CPU and CUDA activity, every thread
where the installed torch offers it) a little before the traced window,
so that launches lost at the start of a session fall outside it, marks
the window with a ``bench.active`` annotation, exports the session's
Chrome trace to the run's temporary directory and reads it back:

* busy: the union of the device's kernels, copies and sets inside the
  window; ``busy_s`` and ``window_s`` go into the result's ``device``;
* device time by operation name, clipped to the window;
* idle gaps, each named by the innermost host operation running at its
  middle on any recorded thread.
"""

import collections
import json
import os

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cpu_op', 'user_annotation', 'cuda_runtime', 'cuda_driver',
             'python_function')
MARK = 'bench.active'
NAMED_GAPS = 1000


class Tracer:
    """One profiler session around one traced window."""

    def __init__(self, tmpdir: str, cuda: bool):
        self.tmpdir, self.cuda = tmpdir, cuda
        self.summary = None
        self._prof = None
        self._mark = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        kw = dict(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if self.cuda else []))
        try:
            from torch.profiler import _ExperimentalConfig
            kw['experimental_config'] = _ExperimentalConfig(
                profile_all_threads=True)
            self._prof = profile(**kw)
        except (ImportError, TypeError):
            kw.pop('experimental_config', None)
            self._prof = profile(**kw)
        self._prof.start()

    def open(self):
        """Open the traced window (on the thread that will close it)."""
        import torch
        self._mark = torch.autograd.profiler.record_function(MARK)
        self._mark.__enter__()

    def close(self):
        self._mark.__exit__(None, None, None)

    def stop(self):
        self._prof.stop()

    def read(self):
        """The stopped session's trace, read back."""
        path = os.path.join(self.tmpdir, 'trace.json')
        self._prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get('traceEvents', [])
        os.remove(path)
        self.summary = TraceSummary(events)
        return self.summary


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class TraceSummary:
    """The device events of one traced window (times in microseconds)."""

    def __init__(self, events):
        marks = [e for e in events if e.get('name') == MARK
                 and e.get('cat') == 'user_annotation' and 'dur' in e]
        if not marks:
            raise RuntimeError(f'the trace holds no {MARK} window')
        mark = max(marks, key=lambda e: e['dur'])
        self.t0 = float(mark['ts'])
        self.t1 = self.t0 + float(mark['dur'])
        self.device = []
        self.host = []
        for e in events:
            if e.get('ph') != 'X' or 'dur' not in e:
                continue
            a = float(e['ts'])
            b = a + float(e['dur'])
            if e.get('cat') in DEVICE_CATS:
                a, b = max(a, self.t0), min(b, self.t1)
                if b > a:
                    self.device.append((e['name'], a, b))
            elif e.get('cat') in HOST_CATS and e['name'] != MARK:
                self.host.append((e['name'], a, b))
        self.busy = _union([(a, b) for _n, a, b in self.device])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def device_s(self, match) -> float:
        """Seconds of device operations whose name ``match(name)`` accepts."""
        return sum(b - a for n, a, b in self.device if match(n)) / 1e6

    def gaps(self):
        """(start, end) of each idle stretch inside the window."""
        edges = [self.t0] + [x for ab in self.busy for x in ab] + [self.t1]
        return [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]

    def breakdown(self, top=10):
        """The device operations that took most time, and the idle time by
        the innermost host operation at each gap's middle."""
        ops = collections.Counter()
        for n, a, b in self.device:
            ops[n[:160]] += (b - a) / 1e6
        import numpy as np
        idle = collections.Counter()
        names = [h[0] for h in self.host]
        starts = np.array([h[1] for h in self.host], np.float64)
        ends = np.array([h[2] for h in self.host], np.float64)
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])
        # the longest gaps one by one; the many short ones between kernels
        # in one sum
        for a, b in gaps[:NAMED_GAPS]:
            mid = (a + b) / 2
            inside = np.flatnonzero((starts <= mid) & (ends >= mid))
            name = (names[inside[np.argmin(ends[inside] - starts[inside])]]
                    [:160] if len(inside) else 'no host operation recorded')
            idle[name] += (b - a) / 1e6
        if len(gaps) > NAMED_GAPS:
            shortest = gaps[NAMED_GAPS - 1]
            idle[f'gaps under {shortest[1] - shortest[0]:.1f} us, '
                 f'not named'] += sum(b - a for a, b in
                                      gaps[NAMED_GAPS:]) / 1e6
        return {'device_ops': [[n, s] for n, s in ops.most_common(top)],
                'idle_gaps': [[n, s] for n, s in idle.most_common(top)]}
