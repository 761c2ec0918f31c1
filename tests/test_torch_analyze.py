"""analyze() end to end: the port (device='cpu') against the JAX package on
the same 16 kHz WAV recordings and the real model_general_v3 bundle.

The CSVs must list the same files, rows and time column; scores may differ
by one unit of the last printed digit (0.01), because a value within f32
rounding of a rounding edge may print the other way.
"""

import csv
import os

import numpy as np
import pytest

import buzzdetect_tpu
import buzzdetect_torch
from buzzdetect_tpu.audio import build_track as jax_build_track
from buzzdetect_torch.audio import UnsupportedFormat, WavDriver
from tests.audio_fixtures import make_tone, write_wav

MODEL = 'model_general_v3'
CHUNK = 20.0   # 20.16 s: several chunks per file, with a ragged last one
ATOL_CSV = 0.01 + 1e-9


@pytest.fixture(scope='module')
def audio(tmp_path_factory):
    root = tmp_path_factory.mktemp('audio')
    rng = np.random.default_rng(12)
    mono = make_tone(47.3, 16000, 330) * (rng.random(1) + 0.5)
    mono = mono + rng.standard_normal(len(mono)).astype(np.float32) * 0.03
    write_wav(root / 'mono.wav', mono, 16000)
    n = int(23.1 * 16000)
    stereo = np.stack([make_tone(23.1, 16000, 520)[:n],
                       rng.standard_normal(n).astype(np.float32) * 0.1], 1)
    (root / 'site').mkdir()
    write_wav(root / 'site' / 'stereo.wav', stereo, 16000)
    return str(root)


def _results(dir_out):
    found = {}
    for base, _dirs, files in os.walk(dir_out):
        for f in files:
            if f.endswith('_buzzdetect.csv'):
                with open(os.path.join(base, f)) as fh:
                    rows = list(csv.reader(fh))
                found[os.path.relpath(os.path.join(base, f), dir_out)] = rows
    return found


def _run(pkg, audio, dir_out, **kw):
    extra = {'device': 'cpu'} if pkg is buzzdetect_torch else {}
    a = pkg.analyze(modelname=MODEL, dir_audio=audio, dir_out=str(dir_out),
                    chunklength=CHUNK, verbosity_print='ERROR', **extra, **kw)
    assert a.coordinator.end_reason == 'completed'
    return _results(str(dir_out))


def _compare(port, ref, label):
    assert sorted(port) == sorted(ref) == ['mono_buzzdetect.csv',
                                           'site/stereo_buzzdetect.csv']
    worst = 0.0
    for name in ref:
        p, r = port[name], ref[name]
        assert p[0] == r[0], name                       # header
        assert len(p) == len(r), name                   # rows
        assert [row[0] for row in p] == [row[0] for row in r], name  # time
        d = np.abs(np.array(p[1:], float)[:, 1:]
                   - np.array(r[1:], float)[:, 1:]).max()
        worst = max(worst, float(d))
    print(f'{label}: max |port - jax| over CSV scores = {worst:.3g}')
    assert worst <= ATOL_CSV


@pytest.mark.parametrize('mode', ['activations', 'detections'])
def test_analyze_matches_jax(audio, tmp_path, mode):
    kw = {'precision': 0.9} if mode == 'detections' else {}
    ref = _run(buzzdetect_tpu, audio, tmp_path / 'jax', **kw)
    port = _run(buzzdetect_torch, audio, tmp_path / 'torch', **kw)
    # 47.3 s: 49 whole frames and the zero-padded start of a 50th
    assert len(ref['mono_buzzdetect.csv']) - 1 == 50
    if mode == 'detections':
        assert port['mono_buzzdetect.csv'][0] == ['start',
                                                  'detections_ins_buzz']
    _compare(port, ref, mode)


def test_resume_from_truncated_partial_matches_full_run(audio, tmp_path):
    full = _run(buzzdetect_torch, audio, tmp_path / 'full')
    dir_out = tmp_path / 'resumed'
    _run(buzzdetect_torch, audio, dir_out)
    # cut the mono result back to the partial a run killed while appending
    # its second chunk leaves on disk: the first chunk's 21 rows (chunk
    # length 20 s rounds to 21 frames, 20.16 s) and a torn row. The resume
    # re-chunks from 20.16 s, as the first run did, so every patch sees the
    # same samples and the CSV must come out byte-identical. (A gap that
    # cuts the original chunks moves each chunk's last patch, whose STFT
    # tail reads the next chunk's samples instead of zero padding — by
    # design, in both packages.)
    done = dir_out / 'mono_buzzdetect.csv'
    lines = done.read_text().splitlines(keepends=True)
    assert lines[22].startswith('20.16,')
    (dir_out / 'mono_buzzpart.csv').write_text(''.join(lines[:22])
                                               + lines[22][:7])
    done.unlink()
    resumed = _run(buzzdetect_torch, audio, dir_out)
    assert (dir_out / 'mono_buzzdetect.csv').read_text() == (
        tmp_path / 'full' / 'mono_buzzdetect.csv').read_text()
    assert resumed == full
    assert not (dir_out / 'mono_buzzpart.csv').exists()


@pytest.mark.parametrize('channels', [1, 2])
def test_wav_driver_gives_the_native_stage_wire(tmp_path, channels):
    """The WAV driver's int16 wire equals the native libav stage's: decode
    int16/32768, equal-weight channel mean, x32767 round-half-even clip."""
    rng = np.random.default_rng(channels)
    data = np.clip(rng.standard_normal((40000, channels)) * 0.4, -1, 1)
    data[:50] = 1.0
    data[50:100] = -1.0
    path = tmp_path / f'c{channels}.wav'
    write_wav(path, data.astype(np.float32), 16000)
    ours, native = WavDriver(str(path)), jax_build_track(str(path))
    try:
        assert ours.frames == native.frames == 40000
        assert ours.source_channels == native.source_channels == channels
        np.testing.assert_array_equal(ours.read_s16(12345),
                                      native.read_s16(12345))
        ours.seek(30000)
        native.seek(30000)
        assert ours.tell() == native.tell() == 30000
        np.testing.assert_array_equal(ours.read(20000), native.read(20000))
    finally:
        ours.close()
        native.close()


def test_wav_driver_refuses_other_rates(tmp_path):
    path = tmp_path / 'fast.wav'
    write_wav(path, np.zeros(44100, np.float32), 44100)
    with pytest.raises(UnsupportedFormat, match='libav'):
        WavDriver(str(path))
