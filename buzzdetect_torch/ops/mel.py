"""Spectral constant matrices: periodic Hann window, windowed-rDFT matrices,
and the HTK mel filterbank.

TPU-first design note: on TPU the cheapest way to compute a 512-point STFT of
25 ms frames is NOT an FFT op (XLA TPU emulates small FFTs poorly) but a dense
matmul on the MXU. We therefore fold the analysis window directly into a pair
of (frame_length, fft_bins) DFT matrices; the whole frontend becomes three
matrix multiplies (DFT real/imag fused into one, then mel).

Math parity targets (validated by tests/test_frontend.py against TensorFlow):
* window: periodic Hann as used by ``tf.signal.stft`` (reference
  `embedders/yamnet/features.py:42-47` relies on that default);
* mel matrix: ``tf.signal.linear_to_mel_weight_matrix`` semantics (HTK mel
  scale, triangular overlapping bands, zeroed DC row) as used at
  `embedders/yamnet/features.py:51-57`.
"""

import numpy as np

_MEL_BREAK_FREQUENCY_HERTZ = 700.0
_MEL_HIGH_FREQUENCY_Q = 1127.0


def hertz_to_mel(frequencies_hertz):
    """HTK mel scale: mel = 1127 * ln(1 + f / 700)."""
    frequencies_hertz = np.asarray(frequencies_hertz, dtype=np.float64)
    return _MEL_HIGH_FREQUENCY_Q * np.log1p(
        frequencies_hertz / _MEL_BREAK_FREQUENCY_HERTZ)


def hann_window_periodic(length: int, dtype=np.float32):
    """Periodic Hann window: 0.5 - 0.5*cos(2*pi*n/length)."""
    n = np.arange(length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / length)).astype(dtype)


def windowed_rdft_matrices(frame_length: int, fft_length: int,
                           dtype=np.float32, symmetric: bool = False):
    """Real-input DFT as matmul, with the Hann window folded in (periodic;
    with ``symmetric`` 0.5 - 0.5 cos(2 pi n / (frame_length - 1)), Kaldi's
    'hanning').

    Returns ``(w_real, w_imag)`` of shape ``(frame_length, fft_length//2 + 1)``
    such that for a frame ``x`` of ``frame_length`` samples::

        rfft(x * hann, fft_length) == x @ w_real + 1j * (x @ w_imag)

    Zero-padding the frame to ``fft_length`` is implicit (rows beyond
    frame_length would be zero, so they are simply absent).
    """
    bins = fft_length // 2 + 1
    n = np.arange(frame_length, dtype=np.float64)
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (
        frame_length - 1 if symmetric else frame_length))
    t = np.arange(frame_length, dtype=np.float64)[:, None]
    k = np.arange(bins, dtype=np.float64)[None, :]
    angle = 2.0 * np.pi * t * k / float(fft_length)
    w_real = (window[:, None] * np.cos(angle)).astype(dtype)
    w_imag = (window[:, None] * -np.sin(angle)).astype(dtype)
    return w_real, w_imag


def mel_weight_matrix(num_mel_bins: int = 64,
                      num_spectrogram_bins: int = 257,
                      sample_rate: float = 16000.0,
                      lower_edge_hertz: float = 125.0,
                      upper_edge_hertz: float = 7500.0,
                      dtype=np.float32):
    """Linear-spectrogram -> mel weight matrix, HTK scale, shape
    ``(num_spectrogram_bins, num_mel_bins)``.

    Triangular bands with edges evenly spaced in mel between the lower and
    upper frequency; the DC bin row is zero.
    """
    bands_to_zero = 1
    nyquist = sample_rate / 2.0
    linear_freqs = np.linspace(0.0, nyquist, num_spectrogram_bins)[bands_to_zero:]
    spectrogram_bins_mel = hertz_to_mel(linear_freqs)[:, None]

    edges_mel = np.linspace(hertz_to_mel(lower_edge_hertz),
                            hertz_to_mel(upper_edge_hertz),
                            num_mel_bins + 2)
    lower_edge_mel = edges_mel[None, 0:num_mel_bins]
    center_mel = edges_mel[None, 1:num_mel_bins + 1]
    upper_edge_mel = edges_mel[None, 2:num_mel_bins + 2]

    lower_slopes = ((spectrogram_bins_mel - lower_edge_mel)
                    / (center_mel - lower_edge_mel))
    upper_slopes = ((upper_edge_mel - spectrogram_bins_mel)
                    / (upper_edge_mel - center_mel))
    weights = np.maximum(0.0, np.minimum(lower_slopes, upper_slopes))

    return np.pad(weights, [[bands_to_zero, 0], [0, 0]]).astype(dtype)


def kaldi_mel_matrix(num_mel_bins: int = 128, fft_length: int = 512,
                     sample_rate: float = 16000.0, low_hz: float = 20.0,
                     high_hz: float = 8000.0, dtype=np.float32):
    """Kaldi's mel filterbank (``torchaudio.compliance.kaldi.get_mel_banks``
    at VTLN warp 1) as a ``(fft_length // 2 + 1, num_mel_bins)`` matrix:
    triangles on the 1127 ln(1 + f / 700) scale, their edges evenly spaced
    in mel from ``low_hz`` to ``high_hz``, over the bins k * rate /
    fft_length, k < fft_length / 2; the Nyquist bin's row zero. Computed in
    float64, rounded once."""
    bins = fft_length // 2
    mel = hertz_to_mel(sample_rate / fft_length * np.arange(bins))[:, None]
    lo, hi = hertz_to_mel(low_hz), hertz_to_mel(high_hz)
    delta = (hi - lo) / (num_mel_bins + 1)
    band = np.arange(num_mel_bins, dtype=np.float64)[None, :]
    left, center, right = (lo + band * delta, lo + (band + 1) * delta,
                           lo + (band + 2) * delta)
    weights = np.maximum(0.0, np.minimum((mel - left) / (center - left),
                                         (right - mel) / (right - center)))
    return np.pad(weights, [[0, 1], [0, 0]]).astype(dtype)
