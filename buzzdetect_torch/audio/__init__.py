"""Audio dispatch: extension -> driver map, track construction, duration.

Copy of ``buzzdetect_tpu/audio/__init__.py`` (parity with reference
`src/stream/audio.py:22-65`) with one change: this package reads 16 kHz
PCM16 WAV through :class:`WavDriver`, built on the standard library's
``wave`` module, in place of the native libav stage. Per-extension driver
modules under ``drivers/`` may add formats exactly like the reference's
plugin directory.
"""

import importlib.util
import os
import wave

import numpy as np

from buzzdetect_torch.audio.driver import AudioDriver
from buzzdetect_torch.utils import quantize_int16, encode_mulaw


class UnsupportedFormat(ValueError):
    pass


_LATER = ('other formats, rates and sample types need the libav decode '
          'stage, which a later slice of the port brings (ROADMAP "Modules '
          'to port": the libav decode stage and resampling)')


class WavDriver(AudioDriver):
    """16-bit PCM WAV at the model rate, downmixed to mono float32.

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
                                    f'{_LATER}') from None
        try:
            rate = self._w.getframerate()
            if self._w.getsampwidth() != 2:
                raise UnsupportedFormat(
                    f'{path}: {8 * self._w.getsampwidth()}-bit samples; '
                    f'this driver reads 16-bit PCM only; {_LATER}')
            if rate != target_rate:
                raise UnsupportedFormat(
                    f'{path}: {rate} Hz; this driver reads {target_rate} Hz '
                    f'only; {_LATER}')
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


def _build_driver_map():
    m = {'wav': WavDriver, 'wave': WavDriver}
    m.update(_discover_plugin_drivers())
    return m


driver_map = _build_driver_map()


def build_track(path_audio: str, target_rate: int = 16000) -> AudioDriver:
    ext = os.path.splitext(path_audio)[1].lower().lstrip('.')
    if ext not in driver_map:
        raise UnsupportedFormat(f'unsupported audio format: .{ext}; '
                                f'{_LATER}')
    return driver_map[ext](path_audio, target_rate)


def get_duration(track: AudioDriver) -> float:
    """Duration in seconds from container metadata (may overestimate for
    truncated recordings; short reads downstream correct for that, as in the
    reference's handle_bad_read path)."""
    if track.frames is None or track.frames < 0:
        raise ValueError('container reports no duration')
    return track.frames / track.samplerate
