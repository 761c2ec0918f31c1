"""Mutation fuzz of the native decode stage (``audio/csrc/buzz_decode.cpp``).

Counterpart of ``tools/fuzz_decode.py``, on the port's build of the stage
(``buzzdetect_torch/audio/ffi.py``); its subprocess workers import
``buzzdetect_torch``.

The decoder runs *in-process* via ctypes: a segfault, abort, or hang on a
malformed container would take down the whole analysis process, not one
worker thread. The reference never hardens this boundary (PyAV absorbs it
in-process too, reference `src/stream/drivers/mp4.py:1`); this tool
proves ours does not crash on corrupted recorder media — the exact input
class a long-running field deployment will eventually see (SD-card bitrot,
torn uploads, half-written captures).

Protocol: pristine fixtures are encoded per codec family, mutated
(byte flips, truncation, zeroed/duplicated regions, garbage insertion,
header smash), and each mutant is exercised in a SUBPROCESS — open, full
bounded read, random seeks, both wire formats. Graceful outcomes (decoded
PCM or DecodeError) exit 0; a Python-level surprise exits 3; signals
(SIGSEGV/SIGABRT) and hangs are what we're hunting. One subprocess batches
all cases and prints an `OK <path>` marker after each, so a crash is
attributed to the first unmarked file and the remainder respawns.

Usage:
    python -m buzzdetect_torch.tools.fuzz_decode --cases 8 --seed 0
    python -m buzzdetect_torch.tools.fuzz_decode --worker mutant1.wav ...
"""

import argparse
import json
import os
import zlib
import signal
import subprocess
import sys
import tempfile

# the checkout's root: the workers run from it, with ``-m``
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# codec -> container extension; one pristine fixture per family
FAMILIES = [
    ('pcm_s16le', 'wav'),
    ('libmp3lame', 'mp3'),
    ('aac', 'm4a'),
    ('wmav2', 'wma'),
    ('ac3', 'mts'),
    ('flac', 'flac'),
    ('libvorbis', 'ogg'),
]

# bounds for the worker: never trust a mutated container's self-reported
# duration — read in fixed slabs with an iteration cap
READ_SLAB = 65536
MAX_SLABS = 64          # <= 4.2 M samples ~= 262 s @16k; fixtures are 4 s
N_SEEKS = 8
# the batch timeout scales with the case count (a healthy-but-slow batch
# must not be misreported as a HANG); the per-case budget is ~100x a
# measured case on the dev host
WORKER_BASE_TIMEOUT_S = 60.0
WORKER_PER_CASE_S = 20.0


def exercise(path: str) -> str:
    """Open and thoroughly exercise one (possibly corrupt) file.

    Returns a short outcome tag; raises only on genuinely unexpected
    Python-level failures. Native crashes kill the process (the point).
    """
    import numpy as np
    from buzzdetect_torch.audio.ffi import NativeStream, DecodeError

    rng = np.random.default_rng(0xB22)
    try:
        t = NativeStream(path, target_rate=16000)
    except DecodeError:
        return 'rejected-open'
    try:
        # half the cases COLD-seek before any linear read: container seek
        # into corrupt data (av_seek_frame + preroll / reopen-count) is a
        # different path than read-then-seek
        # stable hash, NOT built-in hash(): str hashing is salted per
        # process, and the crash-attribution protocol (respawn + rerun in a
        # fresh subprocess) must route the same mutant down the same path
        if zlib.crc32(os.path.basename(path).encode()) & 1:
            try:
                t.seek(max(0, t.frames // 2) if t.frames > 0 else 16000)
                t.read(4096)
                t.seek(0)
            except DecodeError:
                pass
        total = 0
        for _ in range(MAX_SLABS):
            got = t.read(READ_SLAB)
            if not np.all(np.isfinite(got)):
                # non-finite PCM from a corrupt stream is tolerable garbage
                # for the fuzzer's purposes; the pipeline clips downstream
                pass
            total += len(got)
            if len(got) < READ_SLAB:
                break
        hi = max(total, 1)
        for target in rng.integers(0, hi, size=N_SEEKS):
            try:
                t.seek(int(target))
                t.read(4096)
            except DecodeError:
                pass  # graceful refusal mid-stream is fine
        try:
            t.seek(0)
            t.read_s16(4096)
            t.read_mulaw(4096)
        except DecodeError:
            pass
        return f'decoded-{total}'
    except DecodeError:
        return 'rejected-read'
    finally:
        t.close()


def worker_main(paths):
    # acks are BY INDEX into this invocation's path list (paths may contain
    # spaces; an index is unambiguous)
    for i, p in enumerate(paths):
        if (os.environ.get('BZ_FUZZ_SELFCRASH')
                and 'crashme' in os.path.basename(p)):
            # test seam: simulate a native crash so the attribution/respawn
            # protocol itself can be exercised in CI
            os.kill(os.getpid(), signal.SIGSEGV)
        if (os.environ.get('BZ_FUZZ_SELFPYERR')
                and 'pyerrme' in os.path.basename(p)):
            # test seam: simulate the clean exit-3 bail (acked PYERR) so
            # its attribution is distinguishable from a native crash in CI
            print(f'PYERR {i} RuntimeError: injected test failure',
                  flush=True)
            sys.exit(3)
        try:
            tag = exercise(p)
        except Exception as e:  # unexpected Python-level failure
            print(f'PYERR {i} {type(e).__name__}: {e}', flush=True)
            sys.exit(3)
        print(f'OK {i} {tag}', flush=True)
    sys.exit(0)


def mutate(data: bytearray, rng) -> bytes:
    """Apply one randomly chosen corruption to a copy of the container."""
    buf = bytearray(data)
    n = len(buf)
    kind = rng.integers(0, 6)
    if kind == 0:      # flip 1-16 random bytes
        for i in rng.integers(0, n, size=int(rng.integers(1, 17))):
            buf[int(i)] ^= int(rng.integers(1, 256))
    elif kind == 1:    # truncate to a random prefix
        buf = buf[:int(rng.integers(1, n))]
    elif kind == 2:    # zero a random region
        at = int(rng.integers(0, n))
        ln = int(rng.integers(64, 1025))
        buf[at:at + ln] = b'\x00' * min(ln, n - at)
    elif kind == 3:    # insert garbage bytes
        at = int(rng.integers(0, n))
        buf[at:at] = bytes(rng.integers(0, 256,
                                        size=int(rng.integers(1, 257)),
                                        dtype='uint8'))
    elif kind == 4:    # duplicate a region over another
        src = int(rng.integers(0, max(n - 512, 1)))
        dst = int(rng.integers(0, max(n - 512, 1)))
        buf[dst:dst + 512] = buf[src:src + 512]
    else:              # smash the header
        buf[:32] = bytes(rng.integers(0, 256, size=32, dtype='uint8'))
    return bytes(buf)


def run_worker(paths, timeout=None):
    """Run the batched worker; return an outcomes dict path->tag.

    Crash attribution: the worker acks each finished case with an
    `OK <index> <tag>` line (index into ITS argv order, so paths with
    spaces are unambiguous); on a non-zero exit the first unacknowledged
    file is the culprit, and the remainder re-runs in a fresh subprocess.
    """
    outcomes = {}
    pending = list(paths)
    while pending:
        batch_timeout = timeout if timeout is not None else (
            WORKER_BASE_TIMEOUT_S + WORKER_PER_CASE_S * len(pending))
        cmd = [sys.executable, '-m', 'buzzdetect_torch.tools.fuzz_decode',
               '--worker', *pending]
        try:
            proc = subprocess.run(
                cmd, capture_output=True, text=True, timeout=batch_timeout,
                cwd=ROOT)
            out, code = proc.stdout, proc.returncode
        except subprocess.TimeoutExpired as e:
            out = (e.stdout or b'').decode(errors='replace') \
                if isinstance(e.stdout, bytes) else (e.stdout or '')
            code = 'timeout'
        acked = set()
        saw_pyerr = False
        for line in out.splitlines():
            kind, _, rest = line.partition(' ')
            if kind not in ('OK', 'PYERR'):
                continue
            idx_s, _, tag = rest.partition(' ')
            try:
                idx = int(idx_s)
                path = pending[idx]
            except (ValueError, IndexError):
                continue  # garbage on stdout (decoder noise): not an ack
            outcomes[path] = tag if kind == 'OK' else f'PYERR {tag}'
            acked.add(idx)
            saw_pyerr = saw_pyerr or kind == 'PYERR'
        pending = [p for i, p in enumerate(pending) if i not in acked]
        if code == 0:
            break
        # exit 3 after an ACKED PYERR is the worker's own clean bail — the
        # failing file is already recorded, and blaming pending[0] would
        # pin a CRASH on a file that was never exercised (masking any real
        # crasher at that position). Only an un-acked death (signal, torn
        # output, hang) names a culprit.
        if pending and not (code == 3 and saw_pyerr):
            culprit = pending.pop(0)
            outcomes[culprit] = (f'CRASH exit={code}' if code != 'timeout'
                                 else 'HANG')
    return outcomes


def fuzz(cases_per_family: int, seed: int, keep_dir=None):
    """Encode pristine fixtures, mutate, exercise; return findings list."""
    import numpy as np
    from buzzdetect_torch.audio.ffi import encode_fixture

    rng = np.random.default_rng(seed)
    findings = []
    with tempfile.TemporaryDirectory() as tmp:
        mutants = []
        for codec, ext in FAMILIES:
            pristine = os.path.join(tmp, f'pristine.{ext}')
            encode_fixture(pristine, codec, 48000, 1, 4.0)
            data = bytearray(open(pristine, 'rb').read())
            for i in range(cases_per_family):
                m = os.path.join(tmp, f'{codec}_{i}.{ext}')
                with open(m, 'wb') as f:
                    f.write(mutate(data, rng))
                mutants.append(m)
        outcomes = run_worker(mutants)
        tally = {}
        for p, tag in sorted(outcomes.items()):
            kind = tag.split('-')[0].split(' ')[0]
            tally[kind] = tally.get(kind, 0) + 1
            if kind in ('CRASH', 'HANG', 'PYERR'):
                finding = {'file': os.path.basename(p), 'outcome': tag}
                if keep_dir:
                    os.makedirs(keep_dir, exist_ok=True)
                    kept = os.path.join(keep_dir, os.path.basename(p))
                    with open(p, 'rb') as s, open(kept, 'wb') as d:
                        d.write(s.read())
                    finding['reproducer'] = kept
                findings.append(finding)
        print(json.dumps({'cases': len(mutants), 'tally': tally,
                          'findings': findings}))
    return findings


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--worker', nargs='+', metavar='PATH',
                    help='(internal) exercise these files in-process')
    ap.add_argument('--cases', type=int, default=8,
                    help='mutants per codec family')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--keep', default=None,
                    help='directory to keep crash reproducers in')
    args = ap.parse_args(argv)
    if args.worker:
        worker_main(args.worker)
    findings = fuzz(args.cases, args.seed, keep_dir=args.keep)
    sys.exit(1 if findings else 0)


if __name__ == '__main__':
    main()
