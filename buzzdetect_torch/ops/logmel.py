"""The fused log-mel spectrogram: CUDA kernel, plain version, wrapper.

Counterpart of ``buzzdetect_tpu/ops/pallas_frontend.py``
(``log_mel_spectrogram_pallas``), selected with ``frontend='pallas'``: a
padded f32 waveform ``(n,)``, or a batch ``(B, n)``, becomes its
``(n_frames, 64)`` (or ``(B, n_frames, 64)``) log-mel spectrogram, with
``n_frames = 1 + (n - 400) // 160``. On a CUDA tensor the wrapper launches
the kernel of ``csrc/logmel.cu`` (exact f32 FFMA; see the note at the top of
that file) and counts the launch in ``log_mel_spectrogram_fused.launches``;
on a CPU tensor it computes the plain PyTorch version. There is no other
path.

The plain version frames the waveform with ``unfold`` and multiplies by the
(400, 514) windowed-DFT matrix: the same function as the kernel and as the
matmul frontend of ``ops/frontend.py``, formulated on its own.
"""

import ctypes
from functools import lru_cache

import numpy as np
import torch

from buzzdetect_torch.ops import mel as mel_lib
from buzzdetect_torch.ops.sepconv import _count_launch, _route, exact_f32

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
    """The constants as tensors on ``device``, built once per device: the
    plain version's (400, 2*257) windowed-DFT matrix [re | im] and (257, 64)
    mel matrix, and the kernel's DFT in bin chunks (n_chunks, 400, 2*64) of
    [re | im] with bin 256 apart as (400, 2)."""
    key = (cfg.window_samples, cfg.fft_length, cfg.mel_bands, cfg.fft_bins,
           cfg.sample_rate, cfg.mel_min_hz, cfg.mel_max_hz, str(device))
    if key not in _OPERANDS:
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
        _OPERANDS[key] = {
            k: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
            for k, a in (('dft', dft), ('mel', mel), ('chunks', chunks),
                         ('nyq', nyq))}
    return _OPERANDS[key]


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


# --- kernel launch ---------------------------------------------------------------

@lru_cache(maxsize=None)
def load_kernels():
    """Build (once) and load ``csrc/logmel.cu``; returns the ctypes library."""
    from buzzdetect_torch.ops import _build
    lib = _build.load('logmel')
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bz_logmel.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, ctypes.c_longlong,
                              i32, ctypes.c_float, ptr]
    lib.bz_logmel.restype = i32
    lib.bz_logmel_error_string.argtypes = [i32]
    lib.bz_logmel_error_string.restype = ctypes.c_char_p
    return lib


def _launch(waveform, cfg):
    lib = load_kernels()
    b, n = waveform.shape
    n_frames = 1 + (n - WINDOW) // HOP
    ops = _operands(cfg, waveform.device)
    out = torch.empty((b, n_frames, MELS), dtype=torch.float32,
                      device=waveform.device)
    stream = torch.cuda.current_stream(waveform.device).cuda_stream
    with torch.cuda.device(waveform.device):
        code = lib.bz_logmel(waveform.data_ptr(), out.data_ptr(),
                             ops['chunks'].data_ptr(), ops['nyq'].data_ptr(),
                             ops['mel'].data_ptr(),
                             b, n, n_frames, cfg.log_offset, stream)
    if code != 0:
        raise RuntimeError(f'bz_logmel failed: CUDA error {code} '
                           f'({lib.bz_logmel_error_string(code).decode()})')
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
    x = waveform.to(torch.float32).contiguous()
    out = _launch(x.reshape(-1, x.shape[-1]), cfg)
    _count_launch(log_mel_spectrogram_fused)
    return out if waveform.dim() == 2 else out[0]


log_mel_spectrogram_fused.launches = 0
