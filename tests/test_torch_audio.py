"""The port's native decode stage (buzzdetect_torch/audio) against the JAX
package's: bit for bit on every (codec, rate, channels, target rate, wire)
case this machine's FFmpeg encodes, after seeks too; then the stage's own
behaviours (truncated files, files that vanish and come back, closed
streams, mid-stream layout and rate switches, VBR seeks, concurrent decode),
the WAV driver at the native rate, the driver map without the native stage,
and concurrent first builds of the library.

The two libraries are separate builds of one source, loaded side by side in
this process with ctypes' default RTLD_LOCAL.
"""

import os
import shutil
import subprocess
import sys
import threading
import wave

import numpy as np
import pytest

from buzzdetect_tpu.audio import build_track as jax_build_track
from buzzdetect_tpu.audio import ffi as jffi
from buzzdetect_torch import audio
from buzzdetect_torch.audio import (NativeDriver, UnsupportedFormat,
                                    WavDriver, build_track, driver_map)
from buzzdetect_torch.audio import ffi
from buzzdetect_torch.audio.ffi import DecodeError, NativeStream
from tests.audio_fixtures import pcm_pattern, pattern_position, write_wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODECS = [('pcm_s16le', 'wav'), ('flac', 'flac'), ('libmp3lame', 'mp3'),
          ('aac', 'm4a'), ('libvorbis', 'ogg'), ('wmav2', 'wma'),
          ('ac3', 'mts')]
RATES = [8000, 44100, 48000]
WIRES = ('read', 'read_s16', 'read_mulaw')


@pytest.fixture(scope='module')
def fixtures(tmp_path_factory):
    """(codec, rate, channels) -> (port's file, JAX package's file), each
    written by its own package's encode_fixture, or the reason this
    machine's FFmpeg cannot encode it; made on first use."""
    root = tmp_path_factory.mktemp('codecs')
    made = {}

    def get(codec, ext, rate, channels):
        key = (codec, rate, channels)
        if key not in made:
            ours = str(root / f'{codec}_{rate}_{channels}_port.{ext}')
            theirs = str(root / f'{codec}_{rate}_{channels}_jax.{ext}')
            try:
                ffi.encode_fixture(ours, codec, rate, channels, 2.5)
                jffi.encode_fixture(theirs, codec, rate, channels, 2.5)
                made[key] = (ours, theirs)
            except DecodeError as e:
                made[key] = str(e)
        if isinstance(made[key], str):
            pytest.skip(f'this FFmpeg cannot encode {codec} at {rate} Hz, '
                        f'{channels} ch: {made[key]}')
        return made[key]
    return get


def test_native_stage_is_built_in_the_port_from_its_own_source():
    ok, why = ffi.native_status()
    assert ok, why
    assert why.startswith('libavcodec ')
    lib = ffi.get_lib()
    assert os.path.dirname(lib._name) == os.path.join(
        REPO, 'buzzdetect_torch', 'csrc', 'build')
    assert lib._name != jffi.get_lib()._name
    assert driver_map['mp3'] is NativeDriver


@pytest.mark.parametrize('target', [16000, 0])
@pytest.mark.parametrize('channels', [1, 2])
@pytest.mark.parametrize('rate', RATES)
@pytest.mark.parametrize('codec,ext', CODECS)
def test_native_driver_bit_identical_to_jax(fixtures, codec, ext, rate,
                                            channels, target):
    ours_path, jax_path = fixtures(codec, ext, rate, channels)
    with open(ours_path, 'rb') as a, open(jax_path, 'rb') as b:
        same_file = a.read() == b.read()
    ours = build_track(ours_path, target_rate=target)
    ref = jax_build_track(jax_path, target_rate=target)
    assert isinstance(ours, NativeDriver)
    try:
        for attr in ('samplerate', 'native_samplerate', 'source_channels',
                     'frames', 'codec'):
            assert getattr(ours, attr) == getattr(ref, attr), attr
        n = int(2.6 * ours.samplerate)
        for wire in WIRES:
            ours.seek(0)
            ref.seek(0)
            got, want = getattr(ours, wire)(n), getattr(ref, wire)(n)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=wire)
            assert len(got) > 2.3 * ours.samplerate
        rng = np.random.default_rng(rate + channels + target)
        for i, pos in enumerate(rng.integers(0, len(got) - 2048, size=6)):
            wire = WIRES[i % 3]
            ours.seek(int(pos))
            ref.seek(int(pos))
            assert ours.tell() == ref.tell() == int(pos)
            np.testing.assert_array_equal(getattr(ours, wire)(2048),
                                          getattr(ref, wire)(2048),
                                          err_msg=f'{wire} after seek {pos}')
        print(f'{codec} {rate} Hz {channels} ch -> {target or "native"}: '
              f'max |port - jax| = 0 over {len(got)} samples and 6 seeks; '
              f'fixtures byte-identical: {same_file}')
    finally:
        ours.close()
        ref.close()


# --- the stage's own behaviours, mirrored from tests/test_audio.py --------

@pytest.fixture(scope='module')
def pattern_wav(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('pattern') / 'pattern.wav')
    write_wav(path, pcm_pattern(0, 16000 * 10), 16000)
    return path


@pytest.mark.parametrize('target', [12345, 0, 159000, 79999])
def test_wav_seek_sample_accurate(pattern_wav, target):
    t = build_track(pattern_wav, target_rate=16000)
    t.read(777)
    t.seek(target)
    assert t.tell() == target
    np.testing.assert_array_equal(t.read(64), pcm_pattern(target, 64))
    t.close()


def test_truncated_wav_decodes_available_payload(tmp_path, pattern_wav):
    """A byte-truncated WAV decodes whatever payload exists, without
    raising, as the JAX package's stage does."""
    path = str(tmp_path / 'trunc.wav')
    with open(pattern_wav, 'rb') as f:
        blob = f.read()
    with open(path, 'wb') as f:
        f.write(blob[:len(blob) // 2])
    t = build_track(path, target_rate=16000)
    got = t.read(200000)
    t.close()
    assert len(got) == pytest.approx(80000, abs=100)
    np.testing.assert_array_equal(got[:1000], pcm_pattern(0, 1000))
    ref = jax_build_track(path, target_rate=16000)
    np.testing.assert_array_equal(got, ref.read(200000))
    ref.close()


def test_unsupported_extension(tmp_path):
    with pytest.raises(UnsupportedFormat):
        build_track(str(tmp_path / 'x.xyz'))


def test_driver_map_covers_reference_formats():
    for ext in ['wav', 'flac', 'ogg', 'mp3', 'aiff', 'mp4', 'wma', 'mts']:
        assert ext in driver_map, ext


def test_file_vanishes_then_reappears(tmp_path):
    """A backward seek on a reopen-strategy codec reopens the file by path:
    a missing file raises DecodeError on seek and gives EOF on reads, and a
    later seek recovers once the file is back, with the right samples."""
    path = str(tmp_path / 'flaky.wma')
    ffi.encode_fixture(path, 'wmav2', 48000, 1, 3.0)
    backup = str(tmp_path / 'backup.wma')
    shutil.copyfile(path, backup)
    t = NativeStream(path, target_rate=0)
    linear = t.read(96000)
    os.unlink(path)
    with pytest.raises(DecodeError):
        t.seek(0)
    assert len(t.read(4096)) == 0
    with pytest.raises(DecodeError):
        t.seek(96000)
    shutil.copyfile(backup, path)
    t.seek(48000)
    np.testing.assert_array_equal(t.read(4096), linear[48000:52096])
    t.close()


def test_closed_stream_raises_not_crashes(tmp_path):
    path = str(tmp_path / 'fx.wav')
    ffi.encode_fixture(path, 'pcm_s16le', 16000, 1, 1.0)
    t = NativeStream(path, target_rate=0)
    t.read(100)
    t.close()
    for call in (lambda: t.read(10), lambda: t.read_s16(10),
                 lambda: t.read_mulaw(10), lambda: t.seek(0),
                 lambda: t.tell()):
        with pytest.raises(DecodeError, match='closed'):
            call()
    t.close()


def _concat(tmp_path, name, parts):
    out = str(tmp_path / name)
    with open(out, 'wb') as f:
        for rate, channels in parts:
            p = str(tmp_path / f'part_{rate}_{channels}.ac3')
            ffi.encode_fixture(p, 'ac3', rate, channels, 1.0)
            with open(p, 'rb') as src:
                f.write(src.read())
    return out


def _read_all(t):
    chunks = []
    while True:
        got = t.read(65536)
        chunks.append(got)
        if len(got) < 65536:
            return np.concatenate(chunks)


@pytest.mark.parametrize('name,parts,lo,hi', [
    # a layout change is reconfigured and decoded through: both halves
    ('layout', [(48000, 1), (48000, 2)], 1.9, 2.2),
    # a rate change truncates at the switch instead of mislabeling audio
    ('rate', [(48000, 1), (44100, 1)], 0.9, 1.2),
])
def test_midstream_switches(tmp_path, name, parts, lo, hi):
    path = _concat(tmp_path, f'switch_{name}.ac3', parts)
    t = NativeStream(path, target_rate=16000)
    got = _read_all(t)
    t.close()
    assert np.all(np.isfinite(got))
    assert int(lo * 16000) <= len(got) <= int(hi * 16000)
    ref = jffi.NativeStream(path, target_rate=16000)
    np.testing.assert_array_equal(got, _read_all(ref))
    ref.close()


def test_vbr_mp3_seek_matches_linear_decode(tmp_path):
    path = str(tmp_path / 'vbr.mp3')
    ffi.encode_fixture(path, 'libmp3lame', 48000, 1, 20.0, vbr=True)
    kbps = os.path.getsize(path) * 8 / 20.0 / 1000
    assert kbps < 100, f'fixture unexpectedly CBR-sized ({kbps:.0f} kbps)'
    t = build_track(path, target_rate=0)
    linear = t.read(48000 * 21)
    for target in np.random.default_rng(11).integers(
            0, len(linear) - 4096, size=10):
        t.seek(int(target))
        np.testing.assert_array_equal(t.read(4096),
                                      linear[target:target + 4096])
    t.close()


def test_concurrent_decode_sample_accuracy(tmp_path):
    """Several threads decode at once, over distinct files and over the
    same file twice, each landing of a seek storm checked from the sample
    values: no state is shared inside the native stage."""
    paths = []
    for i in range(3):
        p = str(tmp_path / f'p{i}.wav')
        write_wav(p, pcm_pattern(i * 1000000, 16000 * 6), 16000)
        paths.append((p, i * 1000000))
    errors = []

    def storm(path, base, seed):
        try:
            rng = np.random.default_rng(seed)
            t = build_track(path, target_rate=16000)
            for target in rng.integers(0, 16000 * 6 - 64, size=40):
                t.seek(int(target))
                got = t.read(2)
                assert pattern_position(got) % 65536 == \
                    (base + int(target)) % 65536, f'{path}@{target}'
            t.close()
        except Exception as e:  # collected for the main thread
            errors.append(e)
    threads = [threading.Thread(target=storm, args=(p, base, k))
               for k, (p, base) in enumerate(paths * 2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    assert errors == []


def test_wire_encoders_go_through_the_native_stage(monkeypatch):
    """utils.quantize_int16 / encode_mulaw take the native kernels where
    the stage is available, the numpy expressions where it is not; the
    int16 wire is the same either way, mu-law within one code."""
    from buzzdetect_torch import utils
    x = (np.random.default_rng(7).standard_normal(50_000) * 0.6
         ).astype(np.float32)
    x[:8] = [2.0, -2.0, 1.0, -1.0, 0.5, -0.5, 0.0, 1e-9]
    native_q, native_m = utils.quantize_int16(x), utils.encode_mulaw(x)
    np.testing.assert_array_equal(native_q, ffi.quantize_s16(x))
    np.testing.assert_array_equal(native_m, ffi.mulaw_s8(x))
    monkeypatch.setattr(ffi, 'native_status', lambda: (False, 'forced'))
    np.testing.assert_array_equal(utils.quantize_int16(x), native_q)
    d = np.abs(utils.encode_mulaw(x).astype(np.int16)
               - native_m.astype(np.int16)).max()
    print(f'mu-law numpy vs native: max |d| = {d} code')
    assert d <= 1


# --- the WAV driver and the map without the native stage ------------------

@pytest.mark.parametrize('rate,channels', [(44100, 1), (48000, 2),
                                           (16000, 2)])
def test_wav_driver_at_native_rate_matches_native_stage(tmp_path, rate,
                                                        channels):
    """WavDriver(target_rate=0), the on-device resampling path's reader
    where the native stage is unavailable, gives the native stage's
    samples at the file's own rate, bit for bit, after seeks too."""
    rng = np.random.default_rng(rate + channels)
    data = np.clip(rng.standard_normal((3 * rate, channels)) * 0.4, -1, 1)
    path = str(tmp_path / 'native.wav')
    write_wav(path, data.astype(np.float32), rate)
    ours, ref = WavDriver(path, target_rate=0), jax_build_track(path, 0)
    try:
        assert ours.samplerate == ref.samplerate == rate
        assert ours.frames == ref.frames
        assert ours.source_channels == ref.source_channels == channels
        for wire in WIRES:
            ours.seek(0)
            ref.seek(0)
            np.testing.assert_array_equal(getattr(ours, wire)(rate),
                                          getattr(ref, wire)(rate))
        ours.seek(rate + 17)
        ref.seek(rate + 17)
        np.testing.assert_array_equal(ours.read(5000), ref.read(5000))
    finally:
        ours.close()
        ref.close()
    with pytest.raises(UnsupportedFormat, match='libav'):
        WavDriver(path, target_rate=16000 if rate != 16000 else 8000)


def test_driver_map_without_the_native_stage(tmp_path, monkeypatch, caplog):
    """Where the native stage is unavailable the map holds WavDriver for
    wav/wave only, other extensions raise naming the reason, and the choice
    is logged at WARNING level."""
    reason = 'pkg-config finds no FFmpeg development libraries (forced)'
    monkeypatch.setattr(ffi, 'native_status', lambda: (False, reason))
    monkeypatch.setattr(audio, '_map', None)
    with caplog.at_level('WARNING', logger='buzzdetect_torch.audio'):
        m = dict(driver_map)
    assert m == {'wav': WavDriver, 'wave': WavDriver}
    assert any('PCM16 WAV only' in r.message and reason in r.message
               and r.levelname == 'WARNING' for r in caplog.records)
    mp3 = tmp_path / 'x.mp3'
    mp3.write_bytes(b'')
    with pytest.raises(UnsupportedFormat, match='forced'):
        build_track(str(mp3))
    path = str(tmp_path / 'n.wav')
    write_wav(path, np.zeros(4410, np.float32), 44100)
    t = build_track(path, target_rate=0)
    assert isinstance(t, WavDriver) and t.samplerate == 44100
    t.close()
    with pytest.raises(UnsupportedFormat, match='forced'):
        build_track(path, target_rate=16000)


def test_concurrent_first_builds_share_one_library(tmp_path):
    """Four processes building the stage at once into an empty build
    directory: one compiles, the others wait on the lock and load the
    same library; no temporary file is left behind."""
    code = ('import sys\n'
            'from buzzdetect_torch.audio import ffi\n'
            'ffi.DIR_BUILD = sys.argv[1]\n'
            'print(ffi._build())\n'
            'ffi.ctypes.CDLL(ffi._build()).bz_quantize_s16\n')
    procs = [subprocess.Popen([sys.executable, '-c', code, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    built = sorted(os.listdir(tmp_path))
    assert built == ['.buzz_decode.lock', os.path.basename(paths.pop())]


def test_wav_driver_refuses_other_sample_widths(tmp_path):
    path = str(tmp_path / 'u8.wav')
    with wave.open(path, 'wb') as w:
        w.setnchannels(1)
        w.setsampwidth(1)
        w.setframerate(16000)
        w.writeframes(bytes(1600))
    with pytest.raises(UnsupportedFormat, match='16-bit'):
        WavDriver(path, target_rate=0)
