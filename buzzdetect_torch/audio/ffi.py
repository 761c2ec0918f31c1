"""ctypes bindings to the native decode stage (``csrc/buzz_decode.cpp``).

Copy of ``buzzdetect_tpu/audio/ffi.py`` with the same C interface and Python
surface (``NativeStream``, ``quantize_s16``, ``mulaw_s8``,
``encode_fixture``, ``DecodeError``) and two changes:

* the build: ``g++ -O2 -fPIC -std=c++17 -shared`` with the flags
  ``pkg-config`` gives for FFmpeg's libavformat, libavcodec, libavutil and
  libswresample, at first use, into ``buzzdetect_torch/csrc/build/``
  (listed in .gitignore). The file name carries a hash of the source and
  the flags; a file lock serializes concurrent first users across
  processes, and the library is compiled to a temporary name and renamed
  into place, so no process ever loads a half-written file;
* :func:`native_status`, which says whether the stage is available here
  and, if not, why (no FFmpeg found by ``pkg-config``, or the compile
  failed). Without it the package reads PCM16 WAV only (``audio.WavDriver``).

ctypes calls release the GIL, so several streamer threads decode in
parallel. The library is loaded with ctypes' default ``RTLD_LOCAL``: its
``bz_*`` symbols stay private to it, so it may share a process with another
build of the same source.
"""

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, 'csrc', 'buzz_decode.cpp')
DIR_BUILD = os.path.join(os.path.dirname(_DIR), 'csrc', 'build')
CXX_FLAGS = ['-O2', '-fPIC', '-std=c++17', '-shared']
FFMPEG_LIBS = ('libavformat', 'libavcodec', 'libavutil', 'libswresample')

_lib = None
_version = None     # libavcodec's, as pkg-config gives it
_failure = None     # why the stage is unavailable, once that is known
_lib_lock = threading.Lock()


class DecodeError(RuntimeError):
    pass


class FFmpegNotFound(DecodeError):
    """``pkg-config`` finds no FFmpeg development libraries: the native
    stage cannot be built on this machine."""


def ffmpeg_versions() -> dict:
    """``{library: version}`` of FFmpeg's four libraries as ``pkg-config``
    reports them; raises FFmpegNotFound with its message otherwise."""
    try:
        proc = subprocess.run(['pkg-config', '--modversion', *FFMPEG_LIBS],
                              capture_output=True, text=True, timeout=60)
    except FileNotFoundError:
        raise FFmpegNotFound('pkg-config is not installed, so the FFmpeg '
                             'development libraries cannot be found') from None
    if proc.returncode != 0:
        first = (proc.stderr.strip().splitlines() or [''])[0]
        raise FFmpegNotFound(
            f'pkg-config finds no FFmpeg development libraries '
            f'({", ".join(FFMPEG_LIBS)}): {first}')
    return dict(zip(FFMPEG_LIBS, proc.stdout.split()))


def _ffmpeg_flags():
    proc = subprocess.run(['pkg-config', '--cflags', '--libs', *FFMPEG_LIBS],
                          capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise FFmpegNotFound(f'pkg-config --cflags --libs failed: '
                             f'{proc.stderr.strip()}')
    return proc.stdout.split()


def _library_path(flags) -> str:
    """Where the source builds to with ``flags``: the name carries a hash
    of the source and every flag, so an edited source, another compiler
    line or another FFmpeg never loads a stale library."""
    digest = hashlib.sha256(' '.join(CXX_FLAGS + list(flags)).encode())
    with open(_SRC, 'rb') as f:
        digest.update(f.read())
    return os.path.join(DIR_BUILD,
                        f'libbuzz_decode_{digest.hexdigest()[:16]}.so')


def _build() -> str:
    """Compile the source unless its library is already built; returns the
    library path. Raises FFmpegNotFound, or DecodeError with g++'s output."""
    flags = _ffmpeg_flags()
    out = _library_path(flags)
    os.makedirs(DIR_BUILD, exist_ok=True)
    with open(os.path.join(DIR_BUILD, '.buzz_decode.lock'), 'w') as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):
            return out   # built already, perhaps while we waited
        tmp = f'{out}.{os.getpid()}.tmp'
        cmd = ['g++', *CXX_FLAGS, '-o', tmp, _SRC, *flags]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError:
            raise DecodeError('g++ is not installed: the native decode '
                              'stage is built from source') from None
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise DecodeError(
                f'failed to build the native decoder (g++ exit '
                f'{proc.returncode}):\n{proc.stdout}{proc.stderr}')
        os.replace(tmp, out)
    return out


def _declare(lib):
    """The C interface's signatures (as buzzdetect_tpu/audio/ffi.py)."""
    lib.bz_open.restype = ctypes.c_void_p
    lib.bz_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                            ctypes.c_char_p, ctypes.c_int]
    lib.bz_samplerate.restype = ctypes.c_int
    lib.bz_samplerate.argtypes = [ctypes.c_void_p]
    lib.bz_native_samplerate.restype = ctypes.c_int
    lib.bz_native_samplerate.argtypes = [ctypes.c_void_p]
    lib.bz_channels.restype = ctypes.c_int
    lib.bz_channels.argtypes = [ctypes.c_void_p]
    lib.bz_duration_samples.restype = ctypes.c_longlong
    lib.bz_duration_samples.argtypes = [ctypes.c_void_p]
    lib.bz_tell.restype = ctypes.c_longlong
    lib.bz_tell.argtypes = [ctypes.c_void_p]
    lib.bz_codec.restype = ctypes.c_char_p
    lib.bz_codec.argtypes = [ctypes.c_void_p]
    lib.bz_strategy.restype = ctypes.c_int
    lib.bz_strategy.argtypes = [ctypes.c_void_p]
    lib.bz_read.restype = ctypes.c_longlong
    lib.bz_read.argtypes = [ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_float),
                            ctypes.c_longlong]
    lib.bz_read_s16.restype = ctypes.c_longlong
    lib.bz_read_s16.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_int16),
                                ctypes.c_longlong]
    lib.bz_quantize_s16.restype = None
    lib.bz_quantize_s16.argtypes = [ctypes.POINTER(ctypes.c_float),
                                    ctypes.POINTER(ctypes.c_int16),
                                    ctypes.c_longlong]
    lib.bz_read_mulaw.restype = ctypes.c_longlong
    lib.bz_read_mulaw.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int8),
                                  ctypes.c_longlong]
    lib.bz_mulaw_s8.restype = None
    lib.bz_mulaw_s8.argtypes = [ctypes.POINTER(ctypes.c_float),
                                ctypes.POINTER(ctypes.c_int8),
                                ctypes.c_longlong]
    lib.bz_seek.restype = ctypes.c_int
    lib.bz_seek.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    lib.bz_last_error.restype = ctypes.c_int
    lib.bz_last_error.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_int]
    lib.bz_close.restype = None
    lib.bz_close.argtypes = [ctypes.c_void_p]
    lib.bz_encode_fixture.restype = ctypes.c_int
    lib.bz_encode_fixture.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    return lib


def get_lib():
    """The loaded library, built on first call. A failure is remembered:
    later calls raise it again without running the compiler again."""
    global _lib, _version, _failure
    with _lib_lock:
        if _lib is None and _failure is None:
            try:
                _version = ffmpeg_versions()['libavcodec']
                _lib = _declare(ctypes.CDLL(_build()))
            except DecodeError as e:
                _failure = e
            except OSError as e:   # the dynamic loader refused the file
                _failure = DecodeError(f'cannot load the native decoder: '
                                       f'{e}')
        if _failure is not None:
            raise _failure
        return _lib


def native_status():
    """``(True, 'libavcodec <version>')`` where the native stage builds and
    loads here, else ``(False, <reason>)``: FFmpeg not found by
    ``pkg-config``, or the compile failed (with g++'s output)."""
    try:
        get_lib()
    except DecodeError as e:
        return False, str(e)
    return True, f'libavcodec {_version}'


def quantize_s16(samples: np.ndarray) -> np.ndarray:
    """float32 [-1, 1] -> int16 wire format in one native pass (GIL
    released); the same values as utils.quantize_int16's numpy expression."""
    lib = get_lib()
    samples = np.ascontiguousarray(samples, dtype=np.float32)
    out = np.empty(len(samples), dtype=np.int16)
    lib.bz_quantize_s16(
        samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        len(samples))
    return out


def mulaw_s8(samples: np.ndarray) -> np.ndarray:
    """float32 [-1, 1] -> mu-law (mu=255) int8 wire format in one native
    pass. See utils.encode_mulaw for the companding law."""
    lib = get_lib()
    samples = np.ascontiguousarray(samples, dtype=np.float32)
    out = np.empty(len(samples), dtype=np.int8)
    lib.bz_mulaw_s8(
        samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        len(samples))
    return out


def encode_fixture(path: str, codec: str, sample_rate: int = 48000,
                   channels: int = 1, seconds: float = 5.0,
                   vbr: bool = False):
    """Write a deterministic multi-tone test file (tests/tools only).

    ``vbr=True`` encodes in true variable-bitrate mode with a
    complexity-modulated signal, for exercising seek paths where
    byte-interpolated timestamps lie (VBR MP3)."""
    lib = get_lib()
    err = ctypes.create_string_buffer(256)
    ret = lib.bz_encode_fixture(os.fsencode(path), codec.encode(),
                                sample_rate, channels, seconds, err, 256,
                                1 if vbr else 0)
    if ret != 0:
        raise DecodeError(f'encode_fixture({codec}) failed: '
                          f'{err.value.decode(errors="replace")}')
    return path


class NativeStream:
    """A decoded audio stream: mono float32 at ``target_rate`` (or native).

    read/seek/tell positions are in OUTPUT samples.
    """

    def __init__(self, path: str, target_rate: int = 0):
        self._lib = get_lib()
        err = ctypes.create_string_buffer(512)
        # fsencode, not encode(): recorder media can carry non-UTF-8
        # filenames (surrogate-escaped by os.walk) that libav opens fine
        self._h = self._lib.bz_open(os.fsencode(path), int(target_rate),
                                    err, 512)
        if not self._h:
            raise DecodeError(
                f'cannot open {path}: {err.value.decode(errors="replace")}')
        self.path = path
        self.samplerate = self._lib.bz_samplerate(self._h)
        self.native_samplerate = self._lib.bz_native_samplerate(self._h)
        self.channels = self._lib.bz_channels(self._h)
        self.frames = int(self._lib.bz_duration_samples(self._h))
        self.codec = self._lib.bz_codec(self._h).decode()

    def _handle(self):
        """The live native handle; a closed stream must raise a catchable
        error, not pass NULL into C (which dereferences unconditionally)."""
        if not self._h:
            raise DecodeError(f'stream is closed: {self.path}')
        return self._h

    def read(self, n: int, dtype=np.float32) -> np.ndarray:
        if np.dtype(dtype) == np.int16:
            return self.read_s16(n)
        out = np.empty(int(n), dtype=np.float32)
        got = self._lib.bz_read(
            self._handle(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            int(n))
        if got < 0:
            raise DecodeError(f'read failed: {self.last_error()}')
        return out[:got] if dtype == np.float32 else out[:got].astype(dtype)

    def read_s16(self, n: int) -> np.ndarray:
        """Read quantized to the int16 wire format in the same native pass
        (no float materialization in Python at all)."""
        out = np.empty(int(n), dtype=np.int16)
        got = self._lib.bz_read_s16(
            self._handle(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            int(n))
        if got < 0:
            raise DecodeError(f'read failed: {self.last_error()}')
        return out[:got]

    def read_mulaw(self, n: int) -> np.ndarray:
        """Read companded to the mu-law int8 wire format (one native pass)."""
        out = np.empty(int(n), dtype=np.int8)
        got = self._lib.bz_read_mulaw(
            self._handle(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            int(n))
        if got < 0:
            raise DecodeError(f'read failed: {self.last_error()}')
        return out[:got]

    def seek(self, sample: int):
        ret = self._lib.bz_seek(self._handle(), int(sample))
        if ret < 0:
            raise DecodeError(f'seek({sample}) failed: {self.last_error()}')
        return int(sample)

    def tell(self) -> int:
        return int(self._lib.bz_tell(self._handle()))

    def last_error(self) -> str:
        buf = ctypes.create_string_buffer(512)
        self._lib.bz_last_error(self._handle(), buf, 512)
        return buf.value.decode(errors='replace')

    def close(self):
        if self._h:
            self._lib.bz_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
