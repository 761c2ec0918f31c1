"""Audio dispatch: extension -> driver map, track construction, duration.

Copy of ``buzzdetect_tpu/audio/__init__.py`` (parity with reference
`src/stream/audio.py:22-65`): the native libav stage
(``audio/ffi.py``, ``csrc/buzz_decode.cpp``) reads every format in
``NATIVE_EXTENSIONS``, and per-extension driver modules under ``drivers/``
may override entries exactly like the reference's plugin directory. One
change: where the native stage is unavailable (no FFmpeg development
libraries, or its build failed; ``ffi.native_status``), the map holds
:class:`WavDriver`, on the standard library's ``wave`` module, for PCM16
WAV only, and every other extension raises UnsupportedFormat naming the
reason. ``driver_map`` is a mapping, as the JAX package's dict, that
builds itself at its first access. The choice is logged then, once per
process at WARNING level, and ``analyze()`` writes it to its log.
"""

import importlib.util
import logging
import os
import threading
import wave
from collections.abc import MutableMapping

import numpy as np

from buzzdetect_torch.audio import ffi
from buzzdetect_torch.audio.driver import AudioDriver
from buzzdetect_torch.audio.ffi import NativeStream, DecodeError  # noqa: F401 (DecodeError re-exported)
from buzzdetect_torch.utils import quantize_int16, encode_mulaw

_log = logging.getLogger(__name__)


class UnsupportedFormat(ValueError):
    pass


# Formats the native libav stage demuxes+decodes. Mirrors the union of the
# reference's libsndfile formats and its PyAV drivers (mp4/wma/mts), plus the
# containers libav gives us for free.
NATIVE_EXTENSIONS = [
    'wav', 'wave', 'flac', 'ogg', 'oga', 'opus', 'mp3', 'mp2',
    'aiff', 'aif', 'aifc', 'au', 'snd', 'caf', 'w64', 'wv',
    'mp4', 'm4a', 'm4b', 'aac', 'wma', 'asf',
    'mts', 'm2ts', 'ts', 'ac3', 'eac3', 'mkv', 'mka', 'webm', 'avi', 'mov',
]


class NativeDriver(AudioDriver):
    """Default driver: the C++ libav stage decoding straight to the model
    rate (mono float32), or at the file's own rate with ``target_rate=0``."""

    def __init__(self, path, target_rate=16000):
        self._s = NativeStream(path, target_rate)
        self.samplerate = self._s.samplerate
        self.native_samplerate = self._s.native_samplerate
        # output is already mono; expose channels=1 so downmix is a no-op
        self.channels = 1
        self.source_channels = self._s.channels
        self.frames = self._s.frames
        self.codec = self._s.codec

    def read(self, n, dtype=None):
        # honor the AudioDriver contract's dtype (NativeStream dispatches
        # int16 to the fused native path; anything else converts)
        return self._s.read(n, dtype=dtype or np.float32)

    def read_s16(self, n):
        # decode straight to the int16 wire format (fused in the C stage) —
        # the streamer prefers this when the model transfers int16
        return self._s.read_s16(n)

    def read_mulaw(self, n):
        # mu-law int8 wire format, likewise fused into the decode pass
        return self._s.read_mulaw(n)

    def seek(self, sample):
        return self._s.seek(sample)

    def tell(self):
        return self._s.tell()

    def close(self):
        self._s.close()


class WavDriver(AudioDriver):
    """16-bit PCM WAV, downmixed to mono float32, at ``target_rate`` (which
    must be the file's rate) or at the file's own rate (``target_rate=0``,
    the streamer's decode rate under ``resample_on_device``).

    Gives the same wire samples as the native stage: each channel decodes to
    ``int16 / 32768``, channels average with equal weights, and the int16
    wire re-quantizes that mean with x32767, round half to even and clip
    (``read_s16``), as ``buzz_decode.cpp`` does in its fused reader.
    """

    def __init__(self, path, target_rate=16000):
        try:
            self._w = wave.open(str(path), 'rb')
        except (wave.Error, EOFError) as e:
            raise UnsupportedFormat(f'{path}: not a PCM WAV file ({e}); '
                                    f'{decoder_choice()}') from None
        try:
            rate = self._w.getframerate()
            if self._w.getsampwidth() != 2:
                raise UnsupportedFormat(
                    f'{path}: {8 * self._w.getsampwidth()}-bit samples; '
                    f'this driver reads 16-bit PCM only; {decoder_choice()}')
            if target_rate and rate != target_rate:
                raise UnsupportedFormat(
                    f'{path}: {rate} Hz; this driver reads at the file\'s '
                    f'own rate only (asked for {target_rate} Hz); '
                    f'{decoder_choice()}')
        except UnsupportedFormat:
            self._w.close()
            raise
        self.samplerate = rate
        self.native_samplerate = rate
        # output is mono; channels=1 so downmix downstream is a no-op
        self.channels = 1
        self.source_channels = self._w.getnchannels()
        self.frames = self._w.getnframes()
        self.codec = 'pcm_s16le'

    def read(self, n, dtype=None):
        raw = np.frombuffer(self._w.readframes(int(n)), '<i2')
        x = raw.astype(np.float32).reshape(-1, self.source_channels) \
            * np.float32(1.0 / 32768.0)
        x = x[:, 0] if self.source_channels == 1 else x.mean(
            axis=1, dtype=np.float32)
        return x if dtype in (None, np.float32) else x.astype(dtype)

    def read_s16(self, n):
        return quantize_int16(self.read(n))

    def read_mulaw(self, n):
        return encode_mulaw(self.read(n))

    def seek(self, sample):
        self._w.setpos(int(sample))

    def tell(self):
        return self._w.tell()

    def close(self):
        self._w.close()


def _discover_plugin_drivers():
    """Import per-extension driver modules from the drivers/ directory.

    A module defines ``EXTENSIONS`` (list of str) and a ``Driver`` class
    accepting (path, target_rate). Parity with the reference's dynamic
    driver discovery (`src/stream/audio.py:27-34`).
    """
    plugins = {}
    dir_drivers = os.path.join(os.path.dirname(__file__), 'drivers')
    if not os.path.isdir(dir_drivers):
        return plugins
    for fname in sorted(os.listdir(dir_drivers)):
        if not fname.endswith('.py') or fname.startswith('_'):
            continue
        path = os.path.join(dir_drivers, fname)
        spec = importlib.util.spec_from_file_location(
            f'buzzdetect_torch.audio.drivers.{fname[:-3]}', path)
        module = importlib.util.module_from_spec(spec)
        try:
            spec.loader.exec_module(module)
            for ext in getattr(module, 'EXTENSIONS', []):
                plugins[ext.lower()] = module.Driver
        except Exception as e:
            # one broken plugin must not make all audio decoding unimportable
            import warnings
            warnings.warn(f'skipping broken audio driver plugin {fname}: '
                          f'{type(e).__name__}: {e}')
    return plugins


def decoder_choice() -> str:
    """One line naming the decoder this process reads audio with, and why."""
    ok, why = ffi.native_status()
    if ok:
        return (f'audio decode: the native libav stage ({why}), '
                f'{len(NATIVE_EXTENSIONS)} extensions')
    return (f'audio decode: PCM16 WAV only (WavDriver), since the native '
            f'libav stage is unavailable: {why}')


def _build_driver_map():
    if ffi.native_status()[0]:
        m = {ext: NativeDriver for ext in NATIVE_EXTENSIONS}
    else:
        m = {'wav': WavDriver, 'wave': WavDriver}
    m.update(_discover_plugin_drivers())
    return m


_map = None
_map_lock = threading.Lock()


def _built_map() -> dict:
    """The extension -> driver dict, built on first use (which builds the
    native stage, or finds why it cannot), when the choice is logged."""
    global _map
    with _map_lock:
        if _map is None:
            _map = _build_driver_map()
            _log.warning(decoder_choice())
        return _map


class _DriverMap(MutableMapping):
    """Extension -> driver class, the JAX package's ``driver_map`` dict as
    a mapping that builds itself at its first access (``_built_map``), so
    importing this module builds nothing. Plugins extend it as the dict:
    ``driver_map['xyz'] = Driver``."""

    def __getitem__(self, ext):
        return _built_map()[ext]

    def __setitem__(self, ext, driver):
        _built_map()[ext] = driver

    def __delitem__(self, ext):
        del _built_map()[ext]

    def __iter__(self):
        return iter(_built_map())

    def __len__(self):
        return len(_built_map())


driver_map = _DriverMap()


def build_track(path_audio: str, target_rate: int = 16000) -> AudioDriver:
    ext = os.path.splitext(path_audio)[1].lower().lstrip('.')
    if ext not in driver_map:
        raise UnsupportedFormat(f'unsupported audio format: .{ext}; '
                                f'{decoder_choice()}')
    return driver_map[ext](path_audio, target_rate)


def get_duration(track: AudioDriver) -> float:
    """Duration in seconds from container metadata (may overestimate for
    truncated recordings; short reads downstream correct for that, as in the
    reference's handle_bad_read path)."""
    if track.frames is None or track.frames < 0:
        raise ValueError('container reports no duration')
    return track.frames / track.samplerate
