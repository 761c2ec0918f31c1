"""The fused log-mel spectrogram: CUDA kernel, plain version, wrapper.

Counterpart of ``buzzdetect_tpu/ops/pallas_frontend.py``
(``log_mel_spectrogram_pallas``), and on a CUDA device the classifier's
default frontend (``models/classifier.resolve_frontend``): a padded
waveform ``(n,)``, or a batch ``(B, n)``, of f32 samples or of the int16
wire (linear PCM, scaled by 2^-15), becomes its ``(n_frames, 64)`` (or
``(B, n_frames, 64)``) log-mel spectrogram, with
``n_frames = 1 + (n - 400) // 160``. On a CUDA tensor the wrapper calls
the ``buzzdetect::log_mel`` custom operator (``ops/library.py``), which
launches the FFT kernel of ``csrc/logmel.cu`` (exact f32 FFMA; see the
note at the top of that file) once and counts the launch in
``log_mel_spectrogram_fused.launches``; the int16 wire goes to the kernel
as it is, which scales it as it loads it. On a CPU tensor it computes the
plain PyTorch version. There is no other path. The launch's tile (frames
per block) is chosen here, by ``launch_geometry``, and passed to the
kernel; ``fft_tables`` builds the window and twiddle tables the kernel
reads.

The plain version frames the waveform with ``unfold`` and multiplies by the
(400, 514) windowed-DFT matrix: the same function as the kernel and as the
matmul frontend of ``ops/frontend.py``, formulated on its own.
"""

import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from buzzdetect_torch.ops import mel as mel_lib
from buzzdetect_torch.ops.sepconv import _route, device_scope, exact_f32

# the frame geometry the kernel is written for
WINDOW, HOP, MELS, FFT = 400, 160, 64, 512
# the wire types the kernel reads (its ``wire`` argument: the index here)
WIRES = (torch.float32, torch.int16)
INT16_SCALE = 1.0 / 32768.0


def _check_geometry(cfg):
    if (cfg.window_samples, cfg.hop_samples, cfg.fft_length, cfg.fft_bins,
            cfg.mel_bands) != (WINDOW, HOP, FFT, FFT // 2 + 1, MELS):
        raise ValueError(
            'the fused log-mel kernel is specialized to the YAMNet geometry '
            '(400-sample frames at hop 160, a 512-point FFT, 257 bins, 64 '
            'mel bands)')


def fft_tables(window_samples: int = WINDOW, fft_length: int = FFT):
    """The kernel's constants besides the mel matrix, each computed in
    float64 and rounded once to f32: the periodic Hann window halved (the
    kernel's even/odd split of the packed FFT then needs no 1/2; halving is
    exact), ``W256^e = exp(-2 pi i e / 256)`` for e < 256, ``W512^k`` for
    k < 128, and pass 1's twiddles ``W256^(t k2)`` at [k2, t] (t, k2 < 16:
    the same values as ``W256[t k2]``, in the order the kernel's lanes read
    them), each as (re, im) rows."""
    n = np.arange(window_samples, dtype=np.float64)
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / window_samples)
    half = fft_length // 2

    def roots(count, order):
        a = -2.0 * np.pi * np.arange(count, dtype=np.float64) / order
        return np.stack([np.cos(a), np.sin(a)], axis=1).astype(np.float32)
    tk = np.arange(16)[:, None] * np.arange(16)[None, :]   # [k2, t]: t k2
    passes = roots(half, half)[tk.reshape(-1)].reshape(16, 16, 2)
    return (hann.astype(np.float32) * np.float32(0.5), roots(half, half),
            roots(half // 2, fft_length), passes)


_OPERANDS = {}


def _operands(cfg, device):
    """The constants as tensors on ``device``, built once per (config,
    device): the plain version's (400, 2*257) windowed-DFT matrix [re | im]
    and the (257, 64) mel matrix, and the kernel's ``fft_tables`` in one
    flat f32 tensor (half window | W256 | W512 | pass 1's W256^(t k2))."""
    key = (cfg, device)
    ops = _OPERANDS.get(key)
    if ops is None:
        w_re, w_im = mel_lib.windowed_rdft_matrices(cfg.window_samples,
                                                    cfg.fft_length)
        dft = np.concatenate([w_re, w_im], axis=1)
        mel = mel_lib.mel_weight_matrix(cfg.mel_bands, cfg.fft_bins,
                                        cfg.sample_rate, cfg.mel_min_hz,
                                        cfg.mel_max_hz)
        tables = np.concatenate([t.reshape(-1) for t in fft_tables(
            cfg.window_samples, cfg.fft_length)])
        ops = _OPERANDS[key] = {
            k: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
            for k, a in (('dft', dft), ('mel', mel), ('tables', tables))}
    return ops


def _samples(waveform: torch.Tensor) -> torch.Tensor:
    """f32 samples of a waveform: the int16 wire scaled by 2^-15 (exact, as
    ``models/classifier._to_float`` and the kernel's load do), any other
    type converted."""
    if waveform.dtype == torch.int16:
        return waveform.to(torch.float32) * INT16_SCALE
    return waveform.to(torch.float32)


def log_mel_spectrogram_fused_plain(waveform: torch.Tensor,
                                    cfg) -> torch.Tensor:
    """Plain version of ``log_mel_spectrogram_fused``: frames by ``unfold``,
    one (400 x 514) DFT product, magnitude, mel product, log, on the
    wrapper's samples (``_samples``). f32 with TF32 off."""
    exact_f32()
    ops = _operands(cfg, waveform.device)
    frames = _samples(waveform).unfold(-1, cfg.window_samples,
                                       cfg.hop_samples)
    spectrum = torch.matmul(frames, ops['dft'])  # (..., n_frames, 2*bins)
    re, im = spectrum.split(cfg.fft_bins, dim=-1)
    magnitude = torch.sqrt(re * re + im * im)
    return torch.log(torch.matmul(magnitude, ops['mel']) + cfg.log_offset)


# --- launch geometry -------------------------------------------------------------

# csrc/logmel.cu's tiles: frames per block (FT), largest first; a block of
# tile FT runs 4 FT threads and every thread does the same work whatever
# FT, so a smaller tile only spreads a small launch over more SMs
FRAME_TILES = (64, 32, 16, 8)
# an earlier candidate (a larger tile) is taken while its busiest SM gets
# at most this much more work than the best candidate's: it stages the
# tables and streams the mel matrix for fewer blocks
NEAR_TIE = 1.10


class Geometry(NamedTuple):
    ft: int          # frames per block
    threads: int     # per block
    grid: tuple      # (frame tiles, batch)
    blocks: int
    busiest: int     # frames of the busiest SM
    mean: float      # the same, averaged over the SMs
    per_sm: int      # blocks an SM runs at once


def launch_geometry(n_frames: int, batch: int, sms: int,
                    active_blocks=None) -> Geometry:
    """The kernel's launch for ``batch`` waveforms of ``n_frames`` frames
    on a card of ``sms`` SMs: of the tiles, the one whose busiest SM gets
    the fewest frames (its ceil(blocks / SMs) blocks of FT frames), or the
    first tile in order (larger first) within ``NEAR_TIE`` of that.
    ``active_blocks`` maps FT to the blocks an SM runs at once (csrc/
    logmel.cu's ``bz_logmel_blocks``); a tile that cannot run (0) is
    skipped. Without it every tile is taken to run."""
    if n_frames <= 0 or batch <= 0 or sms <= 0:
        raise ValueError(f'no launch for n_frames={n_frames}, batch={batch}, '
                         f'sms={sms}')
    cands = []
    for ft in FRAME_TILES:
        per_sm = 1 if active_blocks is None else active_blocks[ft]
        if per_sm <= 0:
            continue
        tiles = -(-n_frames // ft)
        blocks = tiles * batch
        cands.append(Geometry(ft, 4 * ft, (tiles, batch), blocks,
                              -(-blocks // sms) * ft,
                              n_frames * batch / sms, per_sm))
    if not cands:
        raise RuntimeError('no tile of the log-mel kernel fits the card')
    least = min(g.busiest for g in cands)
    return next(g for g in cands if g.busiest <= NEAR_TIE * least)


def block_work(geometry: Geometry, n_frames: int, bx: int, by: int):
    """What block (bx, by) of ``geometry``'s grid computes, as the kernel
    indexes it: (batch row, frames)."""
    ft = geometry.ft
    return by, range(bx * ft, min((bx + 1) * ft, n_frames))


# --- kernel launch ---------------------------------------------------------------

@lru_cache(maxsize=None)
def load_kernels():
    """Build (once) and load ``csrc/logmel.cu``; returns the ctypes library."""
    from buzzdetect_torch.ops import _build
    return bind(_build.load('logmel'))


def bind(lib):
    """Declare the C interface of a library built from ``csrc/logmel.cu``
    on ``lib`` (a ctypes CDLL); returns it. A build of the dense-DFT
    design (``bz_logmel_clusters``, other operands) is refused: its
    interface is not this one."""
    if not hasattr(lib, 'bz_logmel_blocks'):
        raise ValueError('this build of csrc/logmel.cu is the dense-DFT '
                         'design (no bz_logmel_blocks); it takes other '
                         'operands and cannot be called here')
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    i64 = ctypes.c_longlong
    lib.bz_logmel.argtypes = [ptr, i32, ptr, ptr, ptr, i32, i64, i64, i32,
                              ctypes.c_float, i32, ptr]
    lib.bz_logmel.restype = i32
    lib.bz_logmel_blocks.argtypes = [i32, ctypes.POINTER(i32)]
    lib.bz_logmel_blocks.restype = i32
    lib.bz_logmel_error_string.argtypes = [i32]
    lib.bz_logmel_error_string.restype = ctypes.c_char_p
    return lib


def _check_code(lib, name, code):
    if code != 0:
        raise RuntimeError(f'{name} failed: CUDA error {code} '
                           f'({lib.bz_logmel_error_string(code).decode()})')


_CARDS = {}


def _card(device, lib):
    """(SM count, {FT: blocks an SM runs at once}) of ``device`` for
    ``lib``, queried once."""
    key = (device, id(lib))
    card = _CARDS.get(key)
    if card is None:
        blocks = {}
        with device_scope(device):
            for ft in FRAME_TILES:
                count = ctypes.c_int(0)
                _check_code(lib, 'bz_logmel_blocks',
                            lib.bz_logmel_blocks(ft, ctypes.byref(count)))
                blocks[ft] = count.value
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        card = _CARDS[key] = (sms, blocks)
    return card


@lru_cache(maxsize=256)
def _geometry(device, n_frames, batch, lib):
    return launch_geometry(n_frames, batch, *_card(device, lib))


def geometry_on(device, n_frames: int, batch: int, lib=None) -> Geometry:
    """The geometry the kernel launches with for this shape on ``device``
    (a CUDA device)."""
    return _geometry(device, n_frames, batch,
                     load_kernels() if lib is None else lib)


def _launch(waveform, cfg, lib=None, ft=None):
    """(B, n) contiguous f32 or int16 CUDA waveforms -> (B, n_frames, 64)
    through ``bz_logmel`` of this checkout's library, or of ``lib``
    (another build of ``csrc/logmel.cu``, bound by ``bind``), at the tile
    ``ft`` or at ``launch_geometry``'s."""
    ops = _operands(cfg, waveform.device)
    return _launch_operands(waveform, ops['tables'], ops['mel'],
                            cfg.log_offset, lib, ft)


def _paired_rows(waveform):
    """The waveform as the kernel loads it, two samples at once: rows an
    even number of samples apart, the first aligned to two samples. A
    padded chunk (``ops.frontend.padded_length``) always is; an odd length
    or an unaligned view is copied once into rows one sample longer (no
    frame reads the extra sample)."""
    n = waveform.shape[1]
    if n % 2:
        return torch.nn.functional.pad(waveform, (0, 1))
    if waveform.data_ptr() % (2 * waveform.element_size()):
        return waveform.clone()
    return waveform


def _launch_operands(waveform, tables, mel, log_offset, lib=None, ft=None):
    """``_launch`` on the constants of ``_operands`` as given: the CUDA
    implementation of the ``buzzdetect::log_mel`` operator."""
    lib = load_kernels() if lib is None else lib
    b, n = waveform.shape
    n_frames = 1 + (n - WINDOW) // HOP
    device = waveform.device
    if waveform.dtype not in WIRES or not waveform.is_contiguous():
        raise ValueError(f'waveform: expected a contiguous float32 or int16 '
                         f'tensor, got {waveform.dtype}')
    for name, t in (('tables', tables), ('mel', mel)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != device:
            raise ValueError(f'{name}: expected a contiguous float32 tensor '
                             f'on {device}, got {t.dtype} on {t.device}')
    out = torch.empty((b, n_frames, MELS), dtype=torch.float32, device=device)
    if ft is None:
        ft = geometry_on(device, n_frames, b, lib).ft
    with device_scope(device):
        x = _paired_rows(waveform)
        code = lib.bz_logmel(x.data_ptr(), WIRES.index(x.dtype),
                             out.data_ptr(), tables.data_ptr(),
                             mel.data_ptr(), b, n, x.shape[1], n_frames,
                             float(log_offset), ft,
                             torch.cuda.current_stream().cuda_stream)
    _check_code(lib, 'bz_logmel', code)
    return out


def log_mel_spectrogram_fused(waveform: torch.Tensor, cfg) -> torch.Tensor:
    """Padded (n,) or (B, n) waveform -> (n_frames, 64) or (B, n_frames, 64)
    log-mel. f32 samples or the int16 wire (scaled by 2^-15; other types
    are converted to f32 first). Matches ``ops.frontend.log_mel_spectrogram``
    on the same samples to f32 rounding."""
    _check_geometry(cfg)
    if waveform.dim() not in (1, 2):
        raise ValueError(f'expected a (n,) or (B, n) waveform, got '
                         f'{tuple(waveform.shape)}')
    if waveform.shape[-1] < WINDOW or waveform.numel() == 0:
        raise ValueError(f'a waveform needs at least {WINDOW} samples, got '
                         f'{tuple(waveform.shape)}')
    if _route(waveform) == 'cpu':
        return log_mel_spectrogram_fused_plain(waveform, cfg)
    from buzzdetect_torch.ops import library
    x = waveform if waveform.dtype in WIRES else waveform.to(torch.float32)
    x = x.contiguous()
    ops = _operands(cfg, x.device)
    out = library.log_mel(x.reshape(-1, x.shape[-1]),
                          [ops['tables'], ops['mel']],
                          cfg.window_samples, cfg.hop_samples,
                          cfg.log_offset)
    return out if waveform.dim() == 2 else out[0]


log_mel_spectrogram_fused.launches = 0
