"""The fused log-mel spectrogram: CUDA kernel, plain version, wrapper.

Counterpart of ``buzzdetect_tpu/ops/pallas_frontend.py``
(``log_mel_spectrogram_pallas``), selected with ``frontend='pallas'``: a
padded f32 waveform ``(n,)``, or a batch ``(B, n)``, becomes its
``(n_frames, 64)`` (or ``(B, n_frames, 64)``) log-mel spectrogram, with
``n_frames = 1 + (n - 400) // 160``. On a CUDA tensor the wrapper calls
the ``buzzdetect::log_mel`` custom operator (``ops/library.py``), which
launches the kernel of ``csrc/logmel.cu`` (exact f32 FFMA; see the note at
the top of that file) and counts the launch in
``log_mel_spectrogram_fused.launches``;
on a CPU tensor it computes the plain PyTorch version. There is no other
path. The launch's geometry (frames per thread-block cluster, blocks per
cluster) is chosen here, by ``launch_geometry``, and passed to the kernel.

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

# the frame geometry and bin split the kernel is written for
WINDOW, HOP, MELS = 400, 160, 64
BINS_PER_CHUNK = 64


def _check_geometry(cfg):
    if (cfg.window_samples, cfg.hop_samples, cfg.fft_bins,
            cfg.mel_bands) != (WINDOW, HOP, 257, MELS):
        raise ValueError(
            'the fused log-mel kernel is specialized to the YAMNet geometry '
            '(400-sample frames at hop 160, 257 bins, 64 mel bands)')


_OPERANDS = {}


def _operands(cfg, device):
    """The constants as tensors on ``device``, built once per (config,
    device): the plain version's (400, 2*257) windowed-DFT matrix [re | im]
    and (257, 64) mel matrix, and the kernel's DFT in bin chunks
    (n_chunks, 400, 2*64) of [re | im] with bin 256 apart as (400, 2)."""
    key = (cfg, device)
    ops = _OPERANDS.get(key)
    if ops is None:
        w_re, w_im = mel_lib.windowed_rdft_matrices(cfg.window_samples,
                                                    cfg.fft_length)
        dft = np.concatenate([w_re, w_im], axis=1)
        mel = mel_lib.mel_weight_matrix(cfg.mel_bands, cfg.fft_bins,
                                        cfg.sample_rate, cfg.mel_min_hz,
                                        cfg.mel_max_hz)
        bins, c = cfg.fft_bins, BINS_PER_CHUNK
        re, im = dft[:, :bins], dft[:, bins:]
        chunks = np.stack([np.concatenate([re[:, i * c:(i + 1) * c],
                                           im[:, i * c:(i + 1) * c]], axis=1)
                           for i in range((bins - 1) // c)])
        nyq = np.stack([re[:, bins - 1], im[:, bins - 1]], axis=1)
        ops = _OPERANDS[key] = {
            k: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
            for k, a in (('dft', dft), ('mel', mel), ('chunks', chunks),
                         ('nyq', nyq))}
    return ops


def log_mel_spectrogram_fused_plain(waveform: torch.Tensor,
                                    cfg) -> torch.Tensor:
    """Plain version of ``log_mel_spectrogram_fused``: frames by ``unfold``,
    one (400 x 514) DFT product, magnitude, mel product, log. f32 with TF32
    off."""
    exact_f32()
    ops = _operands(cfg, waveform.device)
    frames = waveform.to(torch.float32).unfold(-1, cfg.window_samples,
                                               cfg.hop_samples)
    spectrum = torch.matmul(frames, ops['dft'])  # (..., n_frames, 2*bins)
    re, im = spectrum.split(cfg.fft_bins, dim=-1)
    magnitude = torch.sqrt(re * re + im * im)
    return torch.log(torch.matmul(magnitude, ops['mel']) + cfg.log_offset)


# --- launch geometry -------------------------------------------------------------

# csrc/logmel.cu's geometries: frames per cluster (FT), largest first, and
# blocks per cluster (CS), 2 before 4; a block of rank r owns bin chunks
# [r * N_CHUNKS / CS, (r + 1) * N_CHUNKS / CS) and mel bands
# [r * MELS / CS, (r + 1) * MELS / CS) of its cluster's frames
FRAME_TILES = (128, 64, 32)
CLUSTER_SIZES = (2, 4)
N_CHUNKS = 4
# threads per block at each FT (csrc/logmel.cu: LogmelTile::NT)
THREADS = {128: 256, 64: 256, 32: 256}
# an earlier candidate (a larger tile, or at one tile fewer blocks) is
# taken while its busiest SM gets at most this much more work than the best
# candidate's: it reads fewer shared-memory wavefronts per FFMA, and stages
# each frame's samples, bin 256 and the mel matrix for fewer blocks
NEAR_TIE = 1.10


class Geometry(NamedTuple):
    ft: int          # frames per cluster
    cs: int          # blocks per cluster
    threads: int     # per block
    grid: tuple      # (frame tiles * cs, batch)
    blocks: int
    busiest: int     # (frame, bin chunk) pairs of the busiest SM
    mean: float      # the same, averaged over the SMs
    clusters: int    # clusters at once (cudaOccupancyMaxActiveClusters)


def launch_geometry(n_frames: int, batch: int, sms: int,
                    active_clusters=None) -> Geometry:
    """The kernel's launch for ``batch`` waveforms of ``n_frames`` frames
    on a card of ``sms`` SMs: of the (FT, CS) candidates, the one whose
    busiest SM gets the fewest (frame, bin-chunk) pairs (its
    ceil(blocks / SMs it fills) blocks of FT frames x N_CHUNKS / CS
    chunks), or the first candidate in order (larger tiles first, clusters
    of 2 before 4) within ``NEAR_TIE`` of that.
    ``active_clusters`` maps (FT, CS) to the clusters the card runs at once
    (csrc/logmel.cu's ``bz_logmel_clusters``); without it every SM is
    taken to hold one block. A candidate that cannot run (0 clusters) is
    skipped."""
    if n_frames <= 0 or batch <= 0 or sms <= 0:
        raise ValueError(f'no launch for n_frames={n_frames}, batch={batch}, '
                         f'sms={sms}')
    cands = []
    for ft in FRAME_TILES:
        for cs in CLUSTER_SIZES:
            clusters = (sms // cs if active_clusters is None
                        else active_clusters[ft, cs])
            if clusters <= 0:
                continue
            tiles = -(-n_frames // ft)
            blocks = tiles * cs * batch
            filled = min(sms, clusters * cs)
            busiest = -(-blocks // filled) * ft * (N_CHUNKS // cs)
            cands.append(Geometry(
                ft, cs, THREADS[ft], (tiles * cs, batch), blocks, busiest,
                n_frames * batch * N_CHUNKS / sms, clusters))
    if not cands:
        raise RuntimeError('no geometry of the log-mel kernel fits the card')
    least = min(g.busiest for g in cands)
    return next(g for g in cands if g.busiest <= NEAR_TIE * least)


def block_work(geometry: Geometry, n_frames: int, bx: int, by: int):
    """What block (bx, by) of ``geometry``'s grid computes, as the kernel
    indexes it: (batch row, frames, bin chunks, mel bands), each a
    range."""
    tile, rank = divmod(bx, geometry.cs)
    ft, cs = geometry.ft, geometry.cs
    return (by, range(tile * ft, min((tile + 1) * ft, n_frames)),
            range(rank * N_CHUNKS // cs, (rank + 1) * N_CHUNKS // cs),
            range(rank * MELS // cs, (rank + 1) * MELS // cs))


# --- kernel launch ---------------------------------------------------------------

@lru_cache(maxsize=None)
def load_kernels():
    """Build (once) and load ``csrc/logmel.cu``; returns the ctypes library."""
    from buzzdetect_torch.ops import _build
    return bind(_build.load('logmel'))


def bind(lib):
    """Declare the C interface of a library built from ``csrc/logmel.cu``
    on ``lib`` (a ctypes CDLL); returns it. A build that has
    ``bz_logmel_clusters`` takes the geometry (ft, cs) before the stream;
    an older build (one fixed geometry) does not."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    geometry = [i32, i32] if hasattr(lib, 'bz_logmel_clusters') else []
    lib.bz_logmel.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, ctypes.c_longlong,
                              i32, ctypes.c_float, *geometry, ptr]
    lib.bz_logmel.restype = i32
    if geometry:
        lib.bz_logmel_clusters.argtypes = [i32, i32, ctypes.POINTER(i32)]
        lib.bz_logmel_clusters.restype = i32
    lib.bz_logmel_error_string.argtypes = [i32]
    lib.bz_logmel_error_string.restype = ctypes.c_char_p
    return lib


def _check_code(lib, name, code):
    if code != 0:
        raise RuntimeError(f'{name} failed: CUDA error {code} '
                           f'({lib.bz_logmel_error_string(code).decode()})')


_CARDS = {}


def _card(device, lib):
    """(SM count, {(FT, CS): clusters at once}) of ``device`` for ``lib``,
    queried once."""
    key = (device, id(lib))
    card = _CARDS.get(key)
    if card is None:
        clusters = {}
        with device_scope(device):
            for ft in FRAME_TILES:
                for cs in CLUSTER_SIZES:
                    count = ctypes.c_int(0)
                    _check_code(lib, 'bz_logmel_clusters',
                                lib.bz_logmel_clusters(ft, cs,
                                                       ctypes.byref(count)))
                    clusters[ft, cs] = count.value
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        card = _CARDS[key] = (sms, clusters)
    return card


@lru_cache(maxsize=256)
def _geometry(device, n_frames, batch, lib):
    return launch_geometry(n_frames, batch, *_card(device, lib))


def geometry_on(device, n_frames: int, batch: int, lib=None) -> Geometry:
    """The geometry the kernel launches with for this shape on ``device``
    (a CUDA device)."""
    return _geometry(device, n_frames, batch,
                     load_kernels() if lib is None else lib)


def _launch(waveform, cfg, lib=None):
    """(B, n) contiguous f32 CUDA waveforms -> (B, n_frames, 64) through
    ``bz_logmel`` of this checkout's library, or of ``lib`` (another build
    of ``csrc/logmel.cu``, bound by ``bind``)."""
    ops = _operands(cfg, waveform.device)
    return _launch_operands(waveform, ops['chunks'], ops['nyq'], ops['mel'],
                            cfg.log_offset, lib)


def _launch_operands(waveform, chunks, nyq, mel, log_offset, lib=None):
    """``_launch`` on the constants of ``_operands`` as given: the CUDA
    implementation of the ``buzzdetect::log_mel`` operator."""
    lib = load_kernels() if lib is None else lib
    b, n = waveform.shape
    n_frames = 1 + (n - WINDOW) // HOP
    device = waveform.device
    for name, t in (('waveform', waveform), ('chunks', chunks), ('nyq', nyq),
                    ('mel', mel)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != device:
            raise ValueError(f'{name}: expected a contiguous float32 tensor '
                             f'on {device}, got {t.dtype} on {t.device}')
    out = torch.empty((b, n_frames, MELS), dtype=torch.float32, device=device)
    args = [waveform.data_ptr(), out.data_ptr(), chunks.data_ptr(),
            nyq.data_ptr(), mel.data_ptr(), b, n, n_frames, float(log_offset)]
    if hasattr(lib, 'bz_logmel_clusters'):
        g = geometry_on(device, n_frames, b, lib)
        args += [g.ft, g.cs]
    with device_scope(device):
        code = lib.bz_logmel(*args, torch.cuda.current_stream().cuda_stream)
    _check_code(lib, 'bz_logmel', code)
    return out


def log_mel_spectrogram_fused(waveform: torch.Tensor, cfg) -> torch.Tensor:
    """Padded (n,) or (B, n) waveform -> (n_frames, 64) or (B, n_frames, 64)
    log-mel. Matches ``ops.frontend.log_mel_spectrogram`` on the same input
    to f32 rounding."""
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
    x = waveform.to(torch.float32).contiguous()
    ops = _operands(cfg, x.device)
    out = library.log_mel(x.reshape(-1, x.shape[-1]),
                          [ops['chunks'], ops['nyq'], ops['mel']],
                          cfg.window_samples, cfg.hop_samples,
                          cfg.log_offset)
    return out if waveform.dim() == 2 else out[0]


log_mel_spectrogram_fused.launches = 0
