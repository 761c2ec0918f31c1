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

The kernel has a second geometry, the Kaldi fbank of the Audio
Spectrogram Transformer (``KaldiFbankConfig``, ``models/ast.py``): the same
frames, FFT and wire, and per frame its mean subtracted, a 0.97
pre-emphasis and a symmetric Hann window before the FFT, the power
spectrum, a (257, 128) Kaldi mel matrix, log(max(e, floor)) and AST's
normalisation, out as ``(n_frames, 128)``. ``_check_geometry`` takes these
two and refuses any other; the wrapper, the operator and the plain version
follow the configuration's type.
"""

import ctypes
from dataclasses import dataclass
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


@dataclass(frozen=True)
class KaldiFbankConfig:
    """The Audio Spectrogram Transformer's fbank: ``torchaudio.compliance.
    kaldi.fbank`` with the settings AST passes (``htk_compat=True``,
    ``use_energy=False``, ``window_type='hanning'``, ``num_mel_bins=128``,
    ``dither=0``, ``frame_shift=10``; frames of 25 ms with ``snip_edges``,
    each frame's mean removed, pre-emphasis 0.97, a symmetric Hann window,
    the power spectrum of a 512-point FFT, Kaldi mel bands over 20-8000 Hz,
    log(max(e, float32 eps))) at 16 kHz, then AST's normalisation
    (x - norm_mean) / (2 norm_std) with the AudioSet statistics."""
    sample_rate: int = 16000
    window_samples: int = WINDOW
    hop_samples: int = HOP
    fft_length: int = FFT
    mel_bands: int = 128
    mel_min_hz: float = 20.0
    mel_max_hz: float = 8000.0
    preemphasis: float = 0.97
    floor: float = float(np.finfo(np.float32).eps)
    norm_mean: float = -4.2677393
    norm_std: float = 4.5689974

    @property
    def fft_bins(self) -> int:
        return self.fft_length // 2 + 1

    @property
    def shift(self) -> float:
        """What the normalisation adds to the log fbank."""
        return -self.norm_mean

    @property
    def divisor(self) -> float:
        """What the normalisation divides by."""
        return self.norm_std * 2


# the geometries the kernel takes: (frame, hop, FFT, bins, bands) of each
GEOMETRIES = {'yamnet': (WINDOW, HOP, FFT, FFT // 2 + 1, MELS),
              'kaldi': (WINDOW, HOP, FFT, FFT // 2 + 1, 128)}


def _check_geometry(cfg) -> str:
    """'kaldi' for a ``KaldiFbankConfig`` of the Kaldi geometry, 'yamnet'
    for any other configuration of YAMNet's; a ValueError otherwise."""
    kind = 'kaldi' if isinstance(cfg, KaldiFbankConfig) else 'yamnet'
    if (cfg.window_samples, cfg.hop_samples, cfg.fft_length, cfg.fft_bins,
            cfg.mel_bands) != GEOMETRIES[kind]:
        raise ValueError(
            'the fused log-mel kernel is specialized to the YAMNet geometry '
            '(400-sample frames at hop 160, a 512-point FFT, 257 bins, 64 '
            'mel bands) and to the Kaldi fbank geometry of AST (the same '
            'frames and FFT, 128 mel bands)')
    return kind


def fft_tables(window_samples: int = WINDOW, fft_length: int = FFT,
               symmetric: bool = False):
    """The kernel's constants besides the mel matrix, each computed in
    float64 and rounded once to f32: the Hann window halved (periodic, or
    with ``symmetric`` the Kaldi geometry's 0.5 - 0.5 cos(2 pi n / (N - 1));
    the kernel's even/odd split of the packed FFT then needs no 1/2;
    halving is exact), ``W256^e = exp(-2 pi i e / 256)`` for e < 256,
    ``W512^k`` for k < 128, and pass 1's twiddles ``W256^(t k2)`` at [k2, t]
    (t, k2 < 16: the same values as ``W256[t k2]``, in the order the
    kernel's lanes read them), each as (re, im) rows."""
    n = np.arange(window_samples, dtype=np.float64)
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (
        window_samples - 1 if symmetric else window_samples))
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
        kaldi = _check_geometry(cfg) == 'kaldi'
        w_re, w_im = mel_lib.windowed_rdft_matrices(
            cfg.window_samples, cfg.fft_length, symmetric=kaldi)
        dft = np.concatenate([w_re, w_im], axis=1)
        mel = (mel_lib.kaldi_mel_matrix(cfg.mel_bands, cfg.fft_length,
                                        cfg.sample_rate, cfg.mel_min_hz,
                                        cfg.mel_max_hz) if kaldi else
               mel_lib.mel_weight_matrix(cfg.mel_bands, cfg.fft_bins,
                                         cfg.sample_rate, cfg.mel_min_hz,
                                         cfg.mel_max_hz))
        tables = np.concatenate([t.reshape(-1) for t in fft_tables(
            cfg.window_samples, cfg.fft_length, symmetric=kaldi)])
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
    wrapper's samples (``_samples``). f32 with TF32 off. The Kaldi geometry
    removes each frame's mean and pre-emphasises it first, takes the power,
    and ends in log(max(e, floor)) and the normalisation."""
    exact_f32()
    kaldi = _check_geometry(cfg) == 'kaldi'
    ops = _operands(cfg, waveform.device)
    frames = _samples(waveform).unfold(-1, cfg.window_samples,
                                       cfg.hop_samples)
    if kaldi:
        frames = frames - frames.mean(dim=-1, keepdim=True)
        before = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - cfg.preemphasis * before
    spectrum = torch.matmul(frames, ops['dft'])  # (..., n_frames, 2*bins)
    re, im = spectrum.split(cfg.fft_bins, dim=-1)
    power = re * re + im * im
    if kaldi:
        fbank = torch.matmul(power, ops['mel'])
        return (torch.log(torch.clamp_min(fbank, cfg.floor)) + cfg.shift) \
            / cfg.divisor
    return torch.log(torch.matmul(torch.sqrt(power), ops['mel'])
                     + cfg.log_offset)


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
    i64, f32 = ctypes.c_longlong, ctypes.c_float
    lib.bz_logmel.argtypes = [ptr, i32, ptr, ptr, ptr, i32, i64, i64, i32,
                              f32, i32, ptr]
    lib.bz_logmel.restype = i32
    lib.bz_logmel_blocks.argtypes = [i32, ctypes.POINTER(i32)]
    lib.bz_logmel_blocks.restype = i32
    # a build from before the Kaldi geometry lacks these; only that
    # geometry needs them
    if hasattr(lib, 'bz_fbank_kaldi'):
        lib.bz_fbank_kaldi.argtypes = [ptr, i32, ptr, ptr, ptr, i32, i64, i64,
                                       i32, f32, f32, f32, i32, ptr]
        lib.bz_fbank_kaldi.restype = i32
        lib.bz_fbank_kaldi_blocks.argtypes = [i32, ctypes.POINTER(i32)]
        lib.bz_fbank_kaldi_blocks.restype = i32
    lib.bz_logmel_error_string.argtypes = [i32]
    lib.bz_logmel_error_string.restype = ctypes.c_char_p
    return lib


def _check_code(lib, name, code):
    if code != 0:
        raise RuntimeError(f'{name} failed: CUDA error {code} '
                           f'({lib.bz_logmel_error_string(code).decode()})')


_CARDS = {}


# the C entries of each geometry: launch, blocks an SM runs at once
ENTRIES = {'yamnet': ('bz_logmel', 'bz_logmel_blocks'),
           'kaldi': ('bz_fbank_kaldi', 'bz_fbank_kaldi_blocks')}


def _card(device, lib, kind='yamnet'):
    """(SM count, {FT: blocks an SM runs at once}) of ``device`` for
    ``lib``'s instantiation of geometry ``kind``, queried once."""
    key = (device, id(lib), kind)
    card = _CARDS.get(key)
    if card is None:
        blocks = {}
        name = ENTRIES[kind][1]
        with device_scope(device):
            for ft in FRAME_TILES:
                count = ctypes.c_int(0)
                _check_code(lib, name, getattr(lib, name)(
                    ft, ctypes.byref(count)))
                blocks[ft] = count.value
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        card = _CARDS[key] = (sms, blocks)
    return card


@lru_cache(maxsize=256)
def _geometry(device, n_frames, batch, lib, kind='yamnet'):
    return launch_geometry(n_frames, batch, *_card(device, lib, kind))


def geometry_on(device, n_frames: int, batch: int, lib=None,
                kind: str = 'yamnet') -> Geometry:
    """The geometry the kernel launches with for this shape on ``device``
    (a CUDA device), in geometry ``kind`` ('yamnet' or 'kaldi')."""
    return _geometry(device, n_frames, batch,
                     load_kernels() if lib is None else lib, kind)


def _launch(waveform, cfg, lib=None, ft=None):
    """(B, n) contiguous f32 or int16 CUDA waveforms -> (B, n_frames, 64)
    through ``bz_logmel`` of this checkout's library, or of ``lib``
    (another build of ``csrc/logmel.cu``, bound by ``bind``), at the tile
    ``ft`` or at ``launch_geometry``'s; in the Kaldi geometry (B, n_frames,
    128) through ``bz_fbank_kaldi``."""
    ops = _operands(cfg, waveform.device)
    if _check_geometry(cfg) == 'kaldi':
        return _launch_operands(waveform, ops['tables'], ops['mel'],
                                cfg.floor, lib, ft, 'kaldi', cfg.shift,
                                cfg.divisor)
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


def _launch_operands(waveform, tables, mel, log_offset, lib=None, ft=None,
                     kind='yamnet', shift=0.0, divisor=1.0):
    """``_launch`` on the constants of ``_operands`` as given: the CUDA
    implementation of the ``buzzdetect::log_mel`` operator. In the Kaldi
    geometry ``log_offset`` is the floor."""
    lib = load_kernels() if lib is None else lib
    bands = GEOMETRIES[kind][-1]
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
    if mel.shape[-1] != bands:
        raise ValueError(f'mel: expected {bands} bands for the {kind} '
                         f'geometry, got {tuple(mel.shape)}')
    out = torch.empty((b, n_frames, bands), dtype=torch.float32,
                      device=device)
    if ft is None:
        ft = geometry_on(device, n_frames, b, lib, kind).ft
    entry = ENTRIES[kind][0]
    post = ((float(log_offset),) if kind == 'yamnet' else
            (float(log_offset), float(shift), float(divisor)))
    with device_scope(device):
        x = _paired_rows(waveform)
        code = getattr(lib, entry)(x.data_ptr(), WIRES.index(x.dtype),
                                   out.data_ptr(), tables.data_ptr(),
                                   mel.data_ptr(), b, n, x.shape[1],
                                   n_frames, *post, ft,
                                   torch.cuda.current_stream().cuda_stream)
    _check_code(lib, entry, code)
    return out


def log_mel_spectrogram_fused(waveform: torch.Tensor, cfg) -> torch.Tensor:
    """Padded (n,) or (B, n) waveform -> (n_frames, 64) or (B, n_frames, 64)
    log-mel. f32 samples or the int16 wire (scaled by 2^-15; other types
    are converted to f32 first). Matches ``ops.frontend.log_mel_spectrogram``
    on the same samples to f32 rounding. With a ``KaldiFbankConfig``, the
    Kaldi fbank, (n_frames, 128) or (B, n_frames, 128)."""
    kind = _check_geometry(cfg)
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
    if kind == 'kaldi':
        out = library.log_mel(x.reshape(-1, x.shape[-1]),
                              [ops['tables'], ops['mel']],
                              cfg.window_samples, cfg.hop_samples, cfg.floor,
                              geometry=kind, shift=cfg.shift,
                              scale=cfg.divisor)
    else:
        out = library.log_mel(x.reshape(-1, x.shape[-1]),
                              [ops['tables'], ops['mel']],
                              cfg.window_samples, cfg.hop_samples,
                              cfg.log_offset)
    return out if waveform.dim() == 2 else out[0]


log_mel_spectrogram_fused.launches = 0
