"""What the port's spectrogram transformers share: the Audio Spectrogram
Transformer (``models/ast.py``) and BEATs (``models/beats.py``).

* ``FbankWindowClassifier``: a ``WireClassifier`` whose chunk is cut into
  windows of a Kaldi fbank (``ops/logmel.KaldiFbankConfig``): the padding
  to whole windows (``_valid``, ``_padded``), the fbank once a chunk inside
  ``buzzdetect.frontend`` (on the card one launch of the fused log-mel
  kernel, which reads the int16 wire itself), the windows as views of it,
  and the windows in blocks of at most ``WINDOW_BLOCK``, each block's
  scores from the architecture's ``_block_scores``;
* the products: ``product`` and ``linear`` (bf16 operands accumulated in
  f32, or exact f32) and ``operand`` (a product's bf16 activation operand);
* ``seeded_normal``, the seeded weights' one draw.
"""

import zlib

import numpy as np
import torch

from buzzdetect_torch.models.classifier import (WireClassifier,
                                                 _frontend_input,
                                                 resolve_device)
from buzzdetect_torch.ops import logmel
from buzzdetect_torch.ops.common import (
    exact_f32, load_libraries, resolve_compute_dtype)
from buzzdetect_torch.runtime.spans import span

# windows a pass of the encoder takes at most: a chunk's windows go through
# in blocks of this many (memory grows with it; a 128-window block of AST
# holds about 5 GB of activations in bf16)
WINDOW_BLOCK = 128


def seeded_normal(seed: int, name: str, shape, std: float) -> np.ndarray:
    """N(0, std^2) of ``shape``, drawn in float64 from ``default_rng(
    SeedSequence([seed, crc32(name)]))`` and rounded to f32."""
    rng = np.random.default_rng(np.random.SeedSequence(
        [int(seed), zlib.crc32(name.encode())]))
    return (rng.standard_normal(shape) * std).astype(np.float32)


def operand(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    """A product's activation operand: bf16 under bf16, else as it is."""
    return x.to(torch.bfloat16) if bf16 else x


def product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) x (N, K)^T in f32. bf16 operands (both bf16) accumulate in f32
    into an f32 product: on the card cuBLAS's ``mm.dtype``, on the CPU the
    f32 product of the same values (each product of two bf16 values is
    exact in f32)."""
    if w.dtype == torch.bfloat16:
        if x.device.type == 'cuda':
            return torch.ops.aten.mm.dtype(x, w.t(), torch.float32)
        x, w = x.to(torch.float32), w.to(torch.float32)
    return torch.mm(x, w.t())


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``product(x, w)`` + b in f32."""
    return product(x, w).add_(b)


def window_hop_frames(cfg, framehop_prop: float) -> int:
    """The window hop in whole 10 ms frames: ``framehop_prop`` of a window
    (``cfg.input_tdim`` frames), rounded; at least one frame."""
    hop = int(round(cfg.input_tdim * framehop_prop))
    if hop < 1:
        raise ValueError(f'framehop_prop={framehop_prop} is below one 10 ms '
                         f'frame of a {cfg.input_tdim}-frame window')
    return hop


class FbankWindowClassifier(WireClassifier):
    """A transformer over windows of a chunk's Kaldi fbank, on the shared
    wire and dispatch (``WireClassifier``).

    A chunk of n samples is padded, as YAMNet's patches are, to whole
    windows of ``cfg.input_tdim`` frames: one for the first window (400 +
    160 (tdim - 1) samples), one for each further window hop or part of
    one, none that would start at or past the chunk's last sample. A
    subclass sets ``name`` (in messages) and ``libraries`` (the kernels it
    launches on CUDA, built and loaded here) and gives ``_block_scores``:
    (W, bands, tdim) fbank windows (freq x time views) -> (W, classes)."""

    name = 'transformer'
    libraries = ('logmel',)

    def _init_windows(self, cfg, fbank, framehop_prop, compute_dtype,
                      device, transfer_dtype):
        """What ``__init__`` shares: sizes, fbank, hop, precision, wire and
        device; on CUDA the libraries built and loaded."""
        self.cfg = cfg
        self.fbank = fbank
        logmel._check_geometry(self.fbank)
        self.hop_frames = window_hop_frames(cfg, framehop_prop)
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        self.bf16 = self.compute_dtype == torch.bfloat16
        self._init_wire(transfer_dtype)
        self.device = resolve_device(device)
        exact_f32()
        if self.device.type == 'cuda':
            load_libraries(self.libraries)

    @property
    def window_samples(self) -> int:
        """Samples of one window: its frames' starts and the last frame."""
        return (self.fbank.window_samples
                + (self.cfg.input_tdim - 1) * self.fbank.hop_samples)

    @property
    def hop_samples(self) -> int:
        return self.hop_frames * self.fbank.hop_samples

    def _valid(self, n_samples: int) -> int:
        extra = max(0, n_samples - self.window_samples)
        n = 1 + -(-extra // self.hop_samples)
        if n_samples > 0:
            n = min(n, (n_samples - 1) // self.hop_samples + 1)
        return max(n, 1)

    def _padded(self, n_samples: int) -> int:
        return self.window_samples + (self._valid(n_samples) - 1) \
            * self.hop_samples

    def _block_scores(self, windows: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _classify(self, wavs: torch.Tensor,
                  resample_args=None) -> torch.Tensor:
        """(..., L) padded wire waveforms -> (..., windows, classes)."""
        if resample_args is not None:
            raise ValueError(f'the {self.name} classifier takes 16 kHz '
                             f'chunks; it does not resample on the device')
        cfg = self.cfg
        with span('buzzdetect.classify'):
            with span('buzzdetect.frontend'):
                fb = logmel.log_mel_spectrogram_fused(
                    _frontend_input(wavs, 'pallas'), self.fbank)
            lead = fb.shape[:-2]
            # (..., W, bands, tdim): each window a view of the fbank
            windows = fb.unfold(-2, cfg.input_tdim, self.hop_frames)
            windows = windows.reshape(-1, self.fbank.mel_bands,
                                      cfg.input_tdim)
            outs = [self._block_scores(windows[lo:lo + WINDOW_BLOCK])
                    for lo in range(0, windows.shape[0], WINDOW_BLOCK)]
            scores = outs[0] if len(outs) == 1 else torch.cat(outs)
            return scores.reshape(*lead, -1, scores.shape[-1])
