"""Host-cost breakdown of a full pipeline run: a sampling profiler over ALL
threads (decode workers, dispatch, writer, logger) during one ``analyze()``
pass, answering "where does the host spend its wall time when the card is
not the bottleneck?".

Counterpart of ``tools/profile_pipeline.py``. Method: a sampler thread walks
``sys._current_frames()`` at ~200 Hz and histograms (thread role, function)
pairs; cProfile cannot see worker threads and the device profiler sees
device work, so this fills the host-side gap. The device-side tool is
``analyze(profile_dir=...)`` (``--torch-trace``): a ``torch.profiler``
trace of the run, CPU ops of every thread and, on the card, its kernels.
Its ``buzzdetect.*`` ranges are the model step's spans
(``runtime/spans.py``: dispatch, wire, upload, classify, frontend, embed,
head, copy_back, wait), and a ``buzzdetect.chunk#<n>`` marker inside a
dispatch, a copy back and a wait ties the three of one chunk together.

Usage:
  python -m buzzdetect_torch.tools.profile_pipeline [--files 4]
        [--seconds-per-file 300] [--transfer-dtype mulaw]
        [--chunklength 200] [--top 12] [--torch-trace DIR] [--device cpu]

The recordings are seeded noise written as 16 kHz WAV (the rate the port's
WAV reader takes). It runs on the card unless given ``--device cpu``.
"""

import argparse
import collections
import os
import sys
import tempfile
import threading
import time

#: leaf frames that mean "blocked/idle", not "spending CPU": queue waits,
#: joins, sleeps — a pipeline thread parked on its queue is the HEALTHY
#: state, so these are reported separately from busy work
_IDLE_LEAVES = ('threading.py:wait', 'threading.py:_wait_for_tstate_lock',
                'threading.py:join', 'time.sleep', 'selectors.py:select')


class Sampler:
    """~200 Hz stack sampler across every live thread."""

    def __init__(self, hz=200):
        self.hz = hz
        self.samples = collections.Counter()   # (role, frame_id) -> hits
        self.per_role = collections.Counter()  # role -> hits
        self.busy = collections.Counter()      # busy-only (role, frame) hits
        self.busy_total = 0
        self.total = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name='stack_sampler')

    @staticmethod
    def _role(name: str) -> str:
        for prefix in ('streamer', 'analyzer', 'writer', 'logger'):
            if name.startswith(prefix):
                return prefix
        return 'main/other'

    def _run(self):
        me = threading.get_ident()
        names = {}
        while not self._stop.is_set():
            names.update({t.ident: t.name for t in threading.enumerate()})
            for ident, frame in sys._current_frames().items():
                if ident == me:
                    continue
                role = self._role(names.get(ident, '?'))
                # innermost frame in repo code, else the true innermost:
                # attributes time to OUR function that is running/blocking,
                # not to queue.get internals
                f, chosen = frame, frame
                while f is not None:
                    fn = f.f_code.co_filename
                    if 'buzzdetect_torch' in fn or 'tools/' in fn:
                        chosen = f
                        break
                    f = f.f_back
                code = chosen.f_code
                leaf = frame.f_code  # what it is concretely doing
                key = (role,
                       f'{os.path.basename(code.co_filename)}:'
                       f'{code.co_name}',
                       f'{os.path.basename(leaf.co_filename)}:'
                       f'{leaf.co_name}')
                self.samples[key] += 1
                self.per_role[role] += 1
                self.total += 1
                if key[2] not in _IDLE_LEAVES:
                    self.busy[key] += 1
                    self.busy_total += 1
            time.sleep(1.0 / self.hz)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)


def report(sampler: Sampler, top: int = 12):
    """The sampler's role shares and its ``top`` busy frames, as lines."""
    s = sampler
    lines = [f'{s.total} stack samples, {s.busy_total} busy '
             f'({100 * s.busy_total / max(1, s.total):.0f}% — the rest is '
             f'threads parked on queues, the healthy state); share by role:']
    for role, hits in s.per_role.most_common():
        lines.append(f'  {role:10s} {100 * hits / max(1, s.total):5.1f}%')
    lines.append(f'top {top} BUSY frames (role, our-frame <- doing), '
                 f'% of wall x threads:')
    for (role, ours, leaf), hits in s.busy.most_common(top):
        doing = '' if leaf == ours else f'  <- {leaf}'
        lines.append(f'  {100 * hits / max(1, s.total):5.1f}%  [{role}] '
                     f'{ours}{doing}')
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(
        description='Sample every thread\'s stack during one analyze() run.')
    ap.add_argument('--files', type=int, default=4)
    ap.add_argument('--seconds-per-file', type=float, default=300.0)
    ap.add_argument('--chunklength', type=float, default=200.0)
    ap.add_argument('--transfer-dtype', default=None,
                    choices=['float32', 'int16', 'mulaw'])
    ap.add_argument('--batch-chunks', type=int, default=1)
    ap.add_argument('--top', type=int, default=12)
    ap.add_argument('--torch-trace', default=None,
                    help='also write a torch.profiler trace here '
                         '(analyze(profile_dir=...)); the model step\'s '
                         'spans are its buzzdetect.* ranges, tied per '
                         'chunk by buzzdetect.chunk#<n> markers')
    ap.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                    help='cuda (default): the card; cpu: the plain versions')
    args = ap.parse_args(argv)

    import numpy as np
    from buzzdetect_torch.analysis import analyze
    from buzzdetect_torch.utils import write_wav

    rng = np.random.default_rng(0)
    kw = dict(chunklength=args.chunklength, verbosity_print='ERROR',
              transfer_dtype=args.transfer_dtype,
              batch_chunks=args.batch_chunks, device=args.device)
    with tempfile.TemporaryDirectory() as td:
        def write(path, seconds):
            write_wav(path, rng.standard_normal(int(seconds * 16000)) * 0.1,
                      16000)

        warm = os.path.join(td, 'warm')
        os.makedirs(warm)
        write(os.path.join(warm, 'w.wav'), args.seconds_per_file)
        analyze(modelname='model_general_v3', dir_audio=warm,
                dir_out=os.path.join(td, 'warm_out'), **kw)

        dir_audio = os.path.join(td, 'audio')
        os.makedirs(dir_audio)
        for i in range(args.files):
            write(os.path.join(dir_audio, f'f{i}.wav'), args.seconds_per_file)

        t0 = time.perf_counter()
        with Sampler() as s:
            analyze(modelname='model_general_v3', dir_audio=dir_audio,
                    dir_out=os.path.join(td, 'out'),
                    profile_dir=args.torch_trace, **kw)
        wall = time.perf_counter() - t0

    audio = args.files * args.seconds_per_file
    print(f'\npipeline on {args.device}: {audio:.0f} audio-seconds in '
          f'{wall:.2f}s = {audio / wall:.0f}x realtime '
          f'(wire={args.transfer_dtype or "int16 (default)"})')
    print('\n'.join(report(s, args.top)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
