#!/usr/bin/env python
"""Counterpart of ``tools/soak_watch.py`` for the port. Edits: imports from
``buzzdetect_torch``; the watcher runs on ``--device`` (the card unless
given ``cpu``) and, with ``--devices N``, with N replicas of the model
(``analyze(devices=...)``, counted on ``--device``'s type); run it as a
module, so no ``sys.path`` edit; ``main`` takes ``argv``. The soak itself
is the JAX package's:

Watch-mode endurance soak: hundreds of fast ``analyze(watch=True)``
cycles against a corpus that grows, gains, and rotates files, asserting
BOUNDED residue — thread count, open file descriptors, resident memory, and
watch-state size. The watcher loops ``one_pass()`` per cycle
(`buzzdetect_torch/analysis.py`), so any per-pass leak (watcher daemon
threads, logger file handles, ``watch_state`` growth, compiled-length
caches) compounds exactly here; the GUI's stop/rerun loop shares the risk.

Usage: python -m buzzdetect_torch.tools.soak_watch [--cycles 300]
       [--interval 0.02] [--device cuda] [--devices N]
Exit 0 = all residue bounds held.
"""

import argparse
import os
import shutil
import tempfile
import threading
import time


def rss_mb() -> float:
    """Current resident set (MB) via /proc (not ru_maxrss, which is a peak)."""
    with open('/proc/self/statm') as f:
        pages = int(f.read().split()[1])
    return pages * os.sysconf('SC_PAGE_SIZE') / 1e6


def n_fds() -> int:
    return len(os.listdir('/proc/self/fd'))


def n_threads() -> int:
    return threading.active_count()


def append_wav(path, samples, rate=16000):
    """Grow a WAV in place the way a field recorder does: append frames and
    patch the header sizes."""
    import struct
    import numpy as np
    pcm = (np.clip(samples, -1, 1) * 32767).astype('<i2').tobytes()
    with open(path, 'r+b') as f:
        f.seek(0, os.SEEK_END)
        f.write(pcm)
        size = f.tell()
        f.seek(4)
        f.write(struct.pack('<I', size - 8))       # RIFF chunk size
        # standard 44-byte header: data size field at offset 40
        f.seek(40)
        f.write(struct.pack('<I', size - 44))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--cycles', type=int, default=300)
    ap.add_argument('--interval', type=float, default=0.02)
    ap.add_argument('--warm-cycles', type=int, default=20,
                    help='cycles before the steady-state measurement')
    ap.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    ap.add_argument('--devices', type=int, default=None,
                    help='replicas of the model (analyze(devices=N))')
    args = ap.parse_args(argv)

    import numpy as np
    from buzzdetect_torch.analysis import analyze
    from buzzdetect_torch.utils import write_wav

    td = tempfile.mkdtemp(prefix='bz_soakwatch_')
    dir_audio = os.path.join(td, 'audio')
    dir_out = os.path.join(td, 'out')
    os.makedirs(dir_audio)
    rng = np.random.default_rng(0)

    def tone(seconds, freq):
        t = np.arange(int(seconds * 16000)) / 16000.0
        return (0.3 * np.sin(2 * np.pi * freq * t)
                + 0.02 * rng.standard_normal(t.shape))

    for i in range(2):
        write_wav(os.path.join(dir_audio, f'base{i}.wav'),
                  tone(2.0, 200 + 50 * i))

    # corpus mutator: grow one recording, add new files, rotate old ones —
    # the live-monitoring workload watch mode exists for
    stop_mutator = threading.Event()
    mutations = {'grow': 0, 'add': 0, 'rotate': 0}

    def mutator():
        k = 0
        while not stop_mutator.is_set():
            time.sleep(0.15)
            k += 1
            try:
                if k % 3 == 0:
                    append_wav(os.path.join(dir_audio, 'base0.wav'),
                               tone(0.5, 200))
                    mutations['grow'] += 1
                elif k % 3 == 1:
                    write_wav(os.path.join(dir_audio, f'new{k}.wav'),
                              tone(1.5, 300))
                    mutations['add'] += 1
                else:
                    # rotate: delete the oldest new* file (recorder log
                    # rotation); keeps the corpus bounded at ~6 files
                    news = sorted(f for f in os.listdir(dir_audio)
                                  if f.startswith('new'))
                    if len(news) > 4:
                        os.remove(os.path.join(dir_audio, news[0]))
                        mutations['rotate'] += 1
            except OSError:
                pass  # racing the streamer on a rotated file is the point

    def run_watch(cycles):
        # alerts + a notification hook included: the hook's dispatcher
        # thread and subprocesses are per-cycle residue candidates too
        return analyze(modelname='model_general_v3', dir_audio=dir_audio,
                       dir_out=dir_out, chunklength=2.0,
                       verbosity_print='CRITICAL',
                       watch=True, watch_interval=args.interval,
                       watch_cycles=cycles,
                       alert_classes='ins_buzz', alert_threshold=-1e9,
                       alert_command='true', device=args.device,
                       devices=args.devices)

    # steady state: model loaded, programs compiled, one full corpus pass
    run_watch(args.warm_cycles)
    base_threads, base_fds, base_rss = n_threads(), n_fds(), rss_mb()
    print(f'steady state after {args.warm_cycles} cycles: '
          f'{base_threads} threads, {base_fds} fds, {base_rss:.1f} MB rss')

    t = threading.Thread(target=mutator, daemon=True)
    t.start()
    t0 = time.time()
    analyzer = run_watch(args.cycles)
    stop_mutator.set()
    t.join(timeout=5)
    wall = time.time() - t0

    # settle: analyze() returns the moment the exit event fires, which is
    # also what wakes the final pass's watcher daemons — up to 3 of them
    # (plus the mutator) can still be alive for a beat; sampling then would
    # flag a spurious residue where there is no leak
    for _ in range(50):
        if n_threads() <= base_threads:
            break
        time.sleep(0.1)

    d_threads = n_threads() - base_threads
    d_fds = n_fds() - base_fds
    d_rss = rss_mb() - base_rss
    n_state = len(analyzer.watch_state) if analyzer.watch_state else 0
    n_files = len([f for f in os.listdir(dir_audio) if f.endswith('.wav')])
    print(f'{args.cycles} cycles in {wall:.1f}s '
          f'({args.cycles / wall:.1f} cycles/s) with corpus mutation '
          f'{mutations}; residue: threads {d_threads:+d}, fds {d_fds:+d}, '
          f'rss {d_rss:+.1f} MB, watch_state {n_state} entries '
          f'({n_files} files on disk)')

    failures = []
    if d_threads > 2:
        failures.append(f'thread residue {d_threads} (> 2)')
    if d_fds > 5:
        failures.append(f'fd residue {d_fds} (> 5)')
    if d_rss > 200:
        failures.append(f'rss residue {d_rss:.1f} MB (> 200)')
    if n_state > n_files + 2:
        failures.append(f'watch_state {n_state} entries for {n_files} files')
    shutil.rmtree(td)
    if failures:
        print('FAIL:', '; '.join(failures))
        raise SystemExit(1)
    print('PASS: residue bounded')


if __name__ == '__main__':
    main()
