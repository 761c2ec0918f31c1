"""Device-side polyphase resampling as one strided convolution.

Port of ``buzzdetect_tpu/ops/resample.py``. The host decode stage resamples
by default (libswresample, fused into decode); this op resamples on the
model's device instead (``analyze(resample_on_device=True)``), for
deployments where host CPU is the bottleneck: the host ships native-rate
int16 and spends no cycles resampling.

Method: Kaiser-windowed sinc polyphase (the soxr/resampy family). The
filter is decomposed into its ``up`` phases and laid out as the output
channels of a SINGLE stride-``down`` convolution: output position
``j = p + m*up`` is row ``m``, channel ``p`` of the conv result. The
kernel's layout is the JAX package's, so the outputs match: each phase
row is as wide as the widest phase's span, so at 44.1 -> 16 kHz
(``up`` = 160, ``down`` = 441) a row holds 528 taps of which 89 are
nonzero.

The convolution is ``F.conv1d`` on the input's own device (cuDNN on the
card), in float32 with TF32 off, as the JAX code asks for
``Precision.HIGHEST``. No hand kernel: the JAX package computes this
outside any Pallas kernel.
"""

import threading
from contextlib import contextmanager
from functools import lru_cache
from math import gcd

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=32)
def _kaiser_sinc_taps(up: int, down: int, num_zeros: int = 16,
                      beta: float = 8.555) -> np.ndarray:
    """Lowpass prototype for rational resampling by up/down: cutoff at
    min(1/up, 1/down) of the upsampled rate, ``num_zeros`` crossings/side."""
    cutoff = min(1.0 / up, 1.0 / down)
    half = int(np.ceil(num_zeros / cutoff))
    n = np.arange(-half, half + 1, dtype=np.float64)
    taps = cutoff * np.sinc(cutoff * n)
    taps *= np.kaiser(len(taps), beta)
    taps *= up / taps.sum()  # unity DC gain after up-dilation
    return taps


@lru_cache(maxsize=32)
def _polyphase_kernel(up: int, down: int, num_zeros: int):
    """Decompose the prototype into a (up, 1, W) conv kernel plus the input
    offset, such that

        y[p + m*up] = sum_w x_padded[m*down + w] * K[p, 0, w]

    Derivation: y[j] = sum_i x[i] * h[half + i*up - j*down]  (centered
    filter). For j = p + m*up the taps hit input indices i = i0_p + k with
    i0_p = ceil((p*down - half) / up) and tap index r_p + k*up,
    r_p = i0_p*up - (p*down - half). Aligning all phases on the common base
    m*down gives kernel row p shifted by (i0_p - i0_min).
    """
    h = _kaiser_sinc_taps(up, down, num_zeros)
    L = len(h)
    half = (L - 1) // 2
    per = -(-L // up)  # taps per phase

    i0 = np.array([int(np.ceil((p * down - half) / up)) for p in range(up)])
    r = i0 * up - (np.arange(up) * down - half)
    assert ((0 <= r) & (r < up)).all()
    i0_min = int(i0.min())
    width = int((i0 - i0_min).max()) + per

    K = np.zeros((up, 1, width), np.float32)
    for p in range(up):
        idx = r[p] + np.arange(per) * up
        valid = idx < L
        K[p, 0, (i0[p] - i0_min) + np.arange(per)[valid]] = h[idx[valid]]
    return K, i0_min, width


@lru_cache(maxsize=32)
def _device_kernel(up: int, down: int, num_zeros: int, device: torch.device):
    """The (up, 1, W) kernel on ``device``, uploaded once per device."""
    K, _, _ = _polyphase_kernel(up, down, num_zeros)
    return torch.from_numpy(K).to(device)


_tf32_lock = threading.Lock()


@contextmanager
def _no_tf32():
    """cuDNN's float32 convolutions without TF32 for the enclosed call,
    the setting restored after (under a lock, so two resampling threads
    cannot restore each other's value)."""
    with _tf32_lock:
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = prev


def resample(x: torch.Tensor, orig_sr: int, target_sr: int,
             num_zeros: int = 16) -> torch.Tensor:
    """1-D (or batched (..., n)) signal from orig_sr to target_sr, float32
    out, on ``x``'s device.

    Output length is ``ceil(n * target_sr / orig_sr)`` (the
    scipy.signal.resample_poly / librosa.resample convention).
    """
    if orig_sr == target_sr:
        # same dtype contract as the converting paths (float32 out)
        return x.to(torch.float32)
    g = gcd(int(orig_sr), int(target_sr))
    up, down = int(target_sr) // g, int(orig_sr) // g
    _, i0_min, width = _polyphase_kernel(up, down, num_zeros)
    K = _device_kernel(up, down, num_zeros, x.device)

    shape = x.shape
    n = shape[-1]
    n_out = -(-n * up // down)
    n_m = -(-n_out // up)  # conv rows needed (may overshoot; trimmed below)

    # pad so the unpadded conv yields >= n_m windows of
    # x[m*down + i0_min : +width]; i0_min = ceil(-half/up) <= 0 always (the
    # kernel half-width covers at least one up-phase)
    assert i0_min <= 0, i0_min
    pad_lo = -i0_min
    pad_hi = max(0, (n_m - 1) * down + width - (n + pad_lo))

    batch = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
    lhs = F.pad(x.reshape(batch, 1, n).to(torch.float32), (pad_lo, pad_hi))
    with _no_tf32():
        out = F.conv1d(lhs, K, stride=down)    # (batch, up, n_m')
    out = out[:, :, :n_m]                      # (batch, up, n_m)
    y = out.transpose(1, 2).reshape(batch, n_m * up)[:, :n_out]
    return y.reshape(*shape[:-1], n_out) if len(shape) > 1 else y[0]

