"""Soak test: a multi-hour synthetic recording analyzed with a mid-run kill
and resume, verifying the final results equal an uninterrupted run
(BASELINE.json configs 3-4).

Counterpart of ``tools/soak_resume.py``: its analysis child imports
``buzzdetect_torch`` and runs on ``--device`` (the card unless given
``cpu``). A codec other than ``wav`` needs the native decode stage.

Usage: python -m buzzdetect_torch.tools.soak_resume [--hours 2]
       [--framehop 1.0] [--codec wav] [--device cuda]
(the kill fires the moment the first checkpoint row reaches disk)
"""

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time

# the checkout's root: the analysis child runs from it
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def write_long_wav(path, seconds, rate=16000):
    """Stream a deterministic tone+noise WAV to disk without holding it in
    memory (days-long files must never materialize — same constraint the
    pipeline honors)."""
    import numpy as np
    import wave
    with wave.open(path, 'wb') as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        step = rate * 60
        rng = np.random.default_rng(0)
        for start in range(0, int(seconds * rate), step):
            n = min(step, int(seconds * rate) - start)
            t = (np.arange(start, start + n)) / rate
            x = (0.2 * np.sin(2 * np.pi * 220 * t)
                 + 0.05 * rng.standard_normal(n))
            w.writeframes((np.clip(x, -1, 1) * 32767).astype('<i2').tobytes())


CHILD = r'''
import sys
from buzzdetect_torch.analysis import analyze
analyze(modelname='model_general_v3', dir_audio=sys.argv[1],
        dir_out=sys.argv[2], chunklength=200,
        framehop_prop=float(sys.argv[3]), verbosity_print='PROGRESS',
        device=sys.argv[4])
'''


def run(dir_audio, dir_out, kill_when_partial=None, framehop=1.0,
        device='cuda'):
    """Run an analysis subprocess; optionally SIGKILL it the moment the named
    partial file holds at least one data row (a genuine mid-flight kill)."""
    p = subprocess.Popen([sys.executable, '-c', CHILD, dir_audio, dir_out,
                          str(framehop), device], cwd=ROOT,
                         stdout=subprocess.DEVNULL,
                         stderr=subprocess.DEVNULL)
    killed = False
    while p.poll() is None:
        if kill_when_partial and os.path.exists(kill_when_partial):
            try:
                with open(kill_when_partial) as f:
                    if sum(1 for _ in f) >= 2:  # header + >=1 row
                        p.kill()  # SIGKILL: the harshest interrupt
                        killed = True
                        break
            except OSError:
                pass
        time.sleep(0.05)
    p.wait()
    return killed


CODECS = {'wav': None,  # streamed WAV writer below (days-long capable)
          'mp3': 'libmp3lame', 'm4a': 'aac', 'wma': 'wmav2',
          'mts': 'ac3', 'flac': 'flac', 'ogg': 'libvorbis'}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--hours', type=float, default=2.0)
    ap.add_argument('--framehop', type=float, default=1.0)
    ap.add_argument('--codec', default='wav', choices=sorted(CODECS),
                    help='source container: compressed codecs make the '
                         'resume exercise the native mid-file seek '
                         'machinery (reopen-and-count / pts+preroll)')
    ap.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    args = ap.parse_args(argv)

    td = tempfile.mkdtemp(prefix='bz_soak_')
    dir_audio = os.path.join(td, 'audio')
    os.makedirs(dir_audio)
    print(f'writing {args.hours:.1f}h synthetic {args.codec} recording...')
    if args.codec == 'wav':
        write_long_wav(os.path.join(dir_audio, 'long.wav'),
                       args.hours * 3600)
    else:
        from buzzdetect_torch.audio.ffi import encode_fixture
        encode_fixture(os.path.join(dir_audio, f'long.{args.codec}'),
                       CODECS[args.codec], 44100, 2, args.hours * 3600)

    # uninterrupted control run
    dir_ctrl = os.path.join(td, 'ctrl')
    t0 = time.time()
    run(dir_audio, dir_ctrl, framehop=args.framehop, device=args.device)
    wall = time.time() - t0
    print(f'control run: {args.hours * 3600 / wall:.0f}x realtime '
          f'({wall:.1f}s)')

    # interrupted run: SIGKILL the moment real progress hits disk, resume
    dir_out = os.path.join(td, 'out')
    partial = os.path.join(dir_out, 'long_buzzpart.csv')
    killed = run(dir_audio, dir_out, kill_when_partial=partial,
                 framehop=args.framehop, device=args.device)
    print(f'killed mid-flight={killed}; partial exists='
          f'{os.path.exists(partial)}')
    assert killed and os.path.exists(partial), \
        'kill landed too late to test resume'
    n_resumes = 1
    run(dir_audio, dir_out, framehop=args.framehop,
        device=args.device)  # resume to completion
    while not os.path.exists(os.path.join(dir_out, 'long_buzzdetect.csv')):
        n_resumes += 1
        if n_resumes > 10:
            raise SystemExit('FAIL: did not complete after 10 resumes')
        run(dir_audio, dir_out, framehop=args.framehop, device=args.device)
    print(f'completed after {n_resumes} resume(s)')

    a = open(os.path.join(dir_ctrl, 'long_buzzdetect.csv')).read()
    b = open(os.path.join(dir_out, 'long_buzzdetect.csv')).read()
    ok = a == b
    print('byte-identical to uninterrupted run:', ok)
    rc = 0
    if not ok:
        # row-level check (chunk boundary frames may differ at padding
        # edges). Missing/duplicated trailing rows count as differences —
        # zip() alone would silently stop at the shorter file and pass the
        # exact truncation regression this soak exists to catch.
        ra, rb = a.splitlines(), b.splitlines()
        print(f'rows: ctrl={len(ra)} resumed={len(rb)}')
        diff = sum(1 for x, y in zip(ra, rb) if x != y)
        diff += abs(len(ra) - len(rb))
        print(f'differing rows (incl. length delta): {diff}')
        rc = 1 if diff > len(ra) * 0.01 else 0
    shutil.rmtree(td)
    raise SystemExit(rc)


if __name__ == '__main__':
    main()
