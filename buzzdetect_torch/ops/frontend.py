"""YAMNet log-mel patch frontend in PyTorch.

Same pipeline as ``buzzdetect_tpu.ops.frontend`` (algorithm parity with
reference `embedders/yamnet/features.py:22-108`):

    waveform (16 kHz f32)
      -> pad to integral patch count        [host-side static length math]
      -> windowed rDFT (Hann folded in) + magnitude
         [hop-banked: 3 shifted contiguous-view matmuls, no frame gather]
      -> 64-bin HTK mel projection          [one matmul]
      -> log(mel + 0.001)
      -> 96-frame patches at stride round(96 * framehop_prop)

The bank and mel products are plain f32 ``torch.matmul`` with TF32 off: the
JAX package leaves them to XLA, outside any kernel. Everything runs in
float32; bfloat16 here would break the 1e-3 score-parity contract.
"""

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from buzzdetect_torch.ops import mel as mel_lib


@dataclass(frozen=True)
class FrontendConfig:
    """Frozen DSP hyperparameters (reference `embedders/yamnet/params.py:25-51`)."""
    sample_rate: int = 16000
    stft_window_seconds: float = 0.025
    stft_hop_seconds: float = 0.010
    mel_bands: int = 64
    mel_min_hz: float = 125.0
    mel_max_hz: float = 7500.0
    log_offset: float = 0.001
    patch_window_seconds: float = 0.96
    patch_hop_seconds: float = 0.48  # = patch_window_seconds * framehop_prop

    @property
    def window_samples(self) -> int:
        return int(round(self.sample_rate * self.stft_window_seconds))  # 400

    @property
    def hop_samples(self) -> int:
        return int(round(self.sample_rate * self.stft_hop_seconds))  # 160

    @property
    def fft_length(self) -> int:
        return 2 ** int(np.ceil(np.log2(self.window_samples)))  # 512

    @property
    def fft_bins(self) -> int:
        return self.fft_length // 2 + 1  # 257

    @property
    def patch_frames(self) -> int:
        return int(round(self.patch_window_seconds / self.stft_hop_seconds))  # 96

    @property
    def patch_hop_frames(self) -> int:
        # spectrogram rate is sample_rate / hop_samples (100 Hz)
        spect_rate = self.sample_rate / self.hop_samples
        return int(round(spect_rate * self.patch_hop_seconds))

    @property
    def patch_hop_samples(self) -> int:
        # MUST stay consistent with patch_hop_frames (which rounds): a
        # truncating int(seconds * rate) here lands one sample short of a
        # frame boundary at framehops like 1/3, dropping the final patch
        return self.patch_hop_frames * self.hop_samples

    def with_framehop(self, framehop_prop: float) -> 'FrontendConfig':
        import dataclasses
        cfg = dataclasses.replace(
            self, patch_hop_seconds=self.patch_window_seconds * framehop_prop)
        if cfg.patch_hop_frames < 1:
            raise ValueError(
                f'framehop_prop={framehop_prop} is below the spectrogram '
                f'resolution (one {self.stft_hop_seconds * 1000:.0f} ms '
                f'frame); the smallest usable value is '
                f'{self.stft_hop_seconds / self.patch_window_seconds:.4f}')
        # snap the seconds value to the spectrogram grid, so result
        # timestamps and resume coverage follow the frames actually analyzed
        return dataclasses.replace(
            cfg, patch_hop_seconds=cfg.patch_hop_samples / cfg.sample_rate)


# --- static length math (host side) ----------------------------------------

def min_waveform_samples(cfg: FrontendConfig) -> int:
    """Samples needed for exactly one patch: one patch window plus the extra
    samples that complete the final STFT analysis window."""
    min_seconds = (cfg.patch_window_seconds
                   + cfg.stft_window_seconds - cfg.stft_hop_seconds)
    return int(min_seconds * cfg.sample_rate)


def num_patches(n_samples: int, cfg: FrontendConfig) -> int:
    """Patch count produced for a waveform of ``n_samples`` (pre-padding).

    The reference rule (`embedders/yamnet/features.py:82-108`): one patch
    for the minimum window, plus one per whole patch hop of remainder
    (rounded up). Trailing patches whose window would START at/after the
    end of the real samples are dropped (sparse framehops > 1).
    """
    if cfg.patch_hop_frames < 1:
        raise ValueError('patch hop is below one spectrogram frame')
    hop = cfg.patch_hop_samples
    extra = max(0, n_samples - min_waveform_samples(cfg))
    n = 1 + int(np.ceil(extra / hop))
    if n_samples > 0:
        n = min(n, (n_samples - 1) // hop + 1)
    return max(n, 1)


def padded_length(n_samples: int, cfg: FrontendConfig) -> int:
    """Length after zero-padding to an integral number of patch hops: grow to
    the one-patch minimum, then round the remainder up to whole hops."""
    min_samples = max(n_samples, min_waveform_samples(cfg))
    after_first = min_samples - min_waveform_samples(cfg)
    hop = cfg.patch_hop_samples
    n_hops = int(np.ceil(after_first / hop)) if hop > 0 else 0
    return min_waveform_samples(cfg) + n_hops * hop


def num_stft_frames(n_padded: int, cfg: FrontendConfig) -> int:
    """STFT frame count for a padded waveform (no end-padding: drop remainder)."""
    return 1 + (n_padded - cfg.window_samples) // cfg.hop_samples


# --- constant operands ------------------------------------------------------

@lru_cache(maxsize=8)
def _dft_mel_constants_np(window_samples, fft_length, hop_samples, mel_bands,
                          fft_bins, sample_rate, mel_min_hz, mel_max_hz):
    """(n_banks, hop, 2*bins) hop-banked windowed-DFT operand and the
    (bins, mel_bands) mel matrix, as numpy f32.

    The (400, 2*bins) fused DFT operand is split into hop-sized row banks
    (400 = 160+160+80, the last zero-padded to 160): the STFT of hop-strided
    frames is then three shifted (n_frames, hop) x (hop, 2*bins) products
    over contiguous views of the signal.
    """
    w_real, w_imag = mel_lib.windowed_rdft_matrices(window_samples,
                                                    fft_length)
    dft = np.concatenate([w_real, w_imag], axis=1)  # (400, 514)
    hop, win = hop_samples, window_samples
    n_banks = -(-win // hop)
    banks = np.zeros((n_banks, hop, dft.shape[1]), np.float32)
    for b in range(n_banks):
        lo, hi = b * hop, min((b + 1) * hop, win)
        banks[b, :hi - lo] = dft[lo:hi]
    mel = mel_lib.mel_weight_matrix(mel_bands, fft_bins,
                                    sample_rate, mel_min_hz, mel_max_hz)
    return banks, mel.astype(np.float32)


_CONSTANTS = {}


def _dft_mel_constants(cfg: FrontendConfig, device):
    """The constants as tensors on ``device``, cached per device."""
    key = (cfg.window_samples, cfg.fft_length, cfg.hop_samples,
           cfg.mel_bands, cfg.fft_bins, cfg.sample_rate, cfg.mel_min_hz,
           cfg.mel_max_hz, str(device))
    if key not in _CONSTANTS:
        banks, mel = _dft_mel_constants_np(*key[:-1])
        _CONSTANTS[key] = (torch.from_numpy(banks).to(device),
                           torch.from_numpy(mel).to(device))
    return _CONSTANTS[key]


def log_mel_spectrogram(waveform: torch.Tensor,
                        cfg: FrontendConfig) -> torch.Tensor:
    """Padded (..., n) waveform -> (..., n_stft_frames, mel_bands) log-mel.

    Frame f spans hop rows f..f+n_banks-1 of the hop-strided signal, so the
    windowed DFT is the sum of n_banks shifted contiguous-view products.
    """
    waveform = waveform.to(torch.float32)
    hop, win = cfg.hop_samples, cfg.window_samples
    n = waveform.shape[-1]
    n_frames = 1 + (n - win) // hop
    banks, mel = _dft_mel_constants(cfg, waveform.device)
    n_banks = banks.shape[0]
    # shifted view b needs samples [b*hop, b*hop + n_frames*hop); the last
    # bank's zero rows let it run past the true window end, so pad the tail
    needed = (n_frames + n_banks - 1) * hop
    if needed > n:
        waveform = torch.nn.functional.pad(waveform, (0, needed - n))
    batch = waveform.shape[:-1]
    spectrum = None
    for b in range(n_banks):
        rows = waveform[..., b * hop:b * hop + n_frames * hop].reshape(
            *batch, n_frames, hop)
        part = torch.matmul(rows, banks[b])
        spectrum = part if spectrum is None else spectrum + part
    re, im = spectrum.chunk(2, dim=-1)            # (..., n_frames, 257) each
    magnitude = torch.sqrt(re * re + im * im)
    return torch.log(torch.matmul(magnitude, mel) + cfg.log_offset)


def patches_from_log_mel(log_mel: torch.Tensor,
                         cfg: FrontendConfig) -> torch.Tensor:
    """(..., n_stft_frames, mel_bands) -> (..., n_patches, patch_frames,
    mel_bands): overlapping patch framing, drop-remainder. At framehop 1.0
    patches tile the spectrogram, so framing is a trim + reshape."""
    pf, hop = cfg.patch_frames, cfg.patch_hop_frames
    n_p = (log_mel.shape[-2] - pf) // hop + 1
    if hop == pf:
        lead = log_mel.shape[:-2]
        return log_mel[..., :n_p * pf, :].reshape(*lead, n_p, pf,
                                                  log_mel.shape[-1])
    idx = (torch.arange(n_p, device=log_mel.device)[:, None] * hop
           + torch.arange(pf, device=log_mel.device)[None, :])
    return log_mel[..., idx, :]


def log_mel_patches(waveform: torch.Tensor,
                    cfg: FrontendConfig) -> torch.Tensor:
    """Padded (..., n) waveform -> (..., n_patches, patch_frames, mel_bands)."""
    return patches_from_log_mel(log_mel_spectrogram(waveform, cfg), cfg)
