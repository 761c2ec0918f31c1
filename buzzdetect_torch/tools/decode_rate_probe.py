"""Measure host decode throughput per codec: audio-seconds decoded per
wall-second per core, through the full native stage (demux -> decode ->
equal-weight downmix -> 16 kHz resample -> chosen wire format).

Counterpart of ``tools/decode_rate_probe.py``, on the port's native stage
(``buzzdetect_torch/audio/ffi.py``). At N x realtime device throughput the
host must decode at N x realtime too or the card starves; this table sizes
the streamer count for a deployment: streamers_needed ~=
target_realtime_factor / rate(codec). A codec this machine's FFmpeg cannot
encode is skipped, with its reason.

Usage:
  python -m buzzdetect_torch.tools.decode_rate_probe [--seconds 120]
        [--wire int16] [--trials 3]

Emits one JSON line per codec plus a markdown table on stderr. Needs the
native stage (FFmpeg's development libraries); without it, it exits 1 with
the reason.
"""

import argparse
import json
import os
import sys
import tempfile
import time

# (codec, container, source_rate) — opus only encodes at 48 kHz
FAMILIES = [
    ('pcm_s16le', 'wav', 44100),
    ('flac', 'flac', 44100),
    ('libmp3lame', 'mp3', 44100),
    ('aac', 'm4a', 44100),
    ('wmav2', 'wma', 44100),
    ('ac3', 'mts', 44100),
    ('libvorbis', 'ogg', 44100),
    ('libopus', 'opus', 48000),
]


def measure(path, wire, target_rate=16000):
    """Audio seconds decoded per wall second, one pass over ``path`` after
    one warming pass (so the page cache holds it: decode, not disk)."""
    from buzzdetect_torch.audio.ffi import NativeStream
    t = NativeStream(path, target_rate=target_rate)
    try:
        read = {'float32': t.read, 'int16': t.read_s16,
                'mulaw': t.read_mulaw}[wire]
        slab = target_rate * 10
        while len(read(slab)) == slab:
            pass
        t.seek(0)
        t0 = time.perf_counter()
        total = 0
        while True:
            got = read(slab)
            total += len(got)
            if len(got) < slab:
                break
        wall = time.perf_counter() - t0
    finally:
        t.close()
    return (total / target_rate) / wall


def probe(families=FAMILIES, seconds=120.0, wire='int16', trials=3):
    """One dict per family: its decode rate (the best of ``trials``), or
    ``skipped`` with the reason where this machine cannot encode it."""
    from buzzdetect_torch.audio.ffi import DecodeError, encode_fixture
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for codec, ext, src_rate in families:
            row = {'codec': codec, 'container': ext, 'wire': wire,
                   'source': f'{src_rate / 1000:g} kHz stereo -> 16 kHz '
                             f'mono'}
            path = os.path.join(tmp, f'fx.{ext}')
            try:
                encode_fixture(path, codec, src_rate, 2, seconds)
            except DecodeError as e:
                rows.append({**row, 'skipped': str(e)})
                continue
            row['decode_realtime_factor'] = max(
                measure(path, wire) for _ in range(trials))
            rows.append(row)
            os.unlink(path)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--seconds', type=float, default=120.0,
                    help='fixture length per codec (stereo)')
    ap.add_argument('--wire', default='int16',
                    choices=['float32', 'int16', 'mulaw'])
    ap.add_argument('--trials', type=int, default=3)
    args = ap.parse_args(argv)

    from buzzdetect_torch.audio.ffi import native_status
    ok, why = native_status()
    if not ok:
        print(f'decode_rate_probe: the native stage is unavailable: {why}',
              file=sys.stderr)
        return 1
    rows = probe(FAMILIES, args.seconds, args.wire, args.trials)
    for row in rows:
        print(json.dumps(row), flush=True)
    print('\n| codec | container | decode rate (x realtime/core) |',
          file=sys.stderr)
    print('|---|---|---|', file=sys.stderr)
    for row in rows:
        rate = (f'{row["decode_realtime_factor"]:.0f}x'
                if 'skipped' not in row else f'skipped: {row["skipped"]}')
        print(f'| {row["codec"]} | {row["container"]} | {rate} |',
              file=sys.stderr)
    return 0


if __name__ == '__main__':
    sys.exit(main())
