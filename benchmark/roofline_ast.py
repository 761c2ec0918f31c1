"""Work of the Audio Spectrogram Transformer: the yardstick of the
``mfu.stream.ast``, ``attention_roofline`` and ``frontend_roofline.ast``
readers.

The counts follow the architecture at the configuration's ``sizes`` (AST's
published ones), not one implementation of it, so they do not go stale when
a later change fuses or reorders the program's work:

* the fbank, a 10 ms frame: its mean and pre-emphasis (4 flops a sample:
  the sum, the subtraction, the product and the difference), the window, a
  512-point real FFT (2.5 N log2 N), the power (3 a bin) and the mel
  product by the nonzero weights of Kaldi's triangular banks
  (``mel_nonzeros``: each bin feeds at most two bands, 504 of the dense
  257 x 128 at 128 bands); its bytes the wire read once and the f32 fbank
  written once;
* a window's products: the patch embedding (2 x 256 x C a patch), each
  block's qkv (2 T C 3C), proj (2 T C^2), fc1 and fc2 (2 x 2 T C M) and
  attention's QK^T and PV (4 T^2 C over its heads), the head (2 C classes);
  attention's bytes are q, k and v read and o written once, 2 bytes each in
  bf16;
* the LayerNorms, GELU, softmax, biases and residual adds are not counted
  as work: they are not products.

Windows of a chunk: the first window (400 + 160 (tdim - 1) samples), one
more for each window hop or part of one, none starting at or past the last
sample. Peaks: ``roofline.PEAKS`` (``roofline.peaks``).
"""

import functools
import math

FRAME, HOP, FFT = 400, 160, 512
# the fbank's mel banks (AST's settings of Kaldi's fbank)
RATE, LOW_HZ, HIGH_HZ = 16000.0, 20.0, 8000.0


def hop_frames(sizes: dict, framehop_prop: float) -> int:
    return max(1, int(round(sizes['input_tdim'] * framehop_prop)))


def windows(n_samples: int, sizes: dict, framehop_prop: float = 1.0) -> int:
    """Windows of a chunk of ``n_samples``."""
    first = FRAME + (sizes['input_tdim'] - 1) * HOP
    step = hop_frames(sizes, framehop_prop) * HOP
    n = 1 + max(0, -(-(n_samples - first) // step))
    return max(1, min(n, (n_samples - 1) // step + 1))


def padded_samples(n_samples: int, sizes: dict,
                   framehop_prop: float = 1.0) -> int:
    """The chunk zero-padded to its windows' whole extent."""
    w = windows(n_samples, sizes, framehop_prop)
    return FRAME + ((w - 1) * hop_frames(sizes, framehop_prop)
                    + sizes['input_tdim'] - 1) * HOP


def frames(n_samples: int, sizes: dict, framehop_prop: float = 1.0) -> int:
    """fbank frames of the padded chunk."""
    return 1 + (padded_samples(n_samples, sizes, framehop_prop)
                - FRAME) // HOP


def tokens(sizes: dict) -> int:
    f = (sizes['input_fdim'] - sizes['patch_size']) // sizes['fstride'] + 1
    t = (sizes['input_tdim'] - sizes['patch_size']) // sizes['tstride'] + 1
    return f * t + 2


@functools.lru_cache(maxsize=None)
def mel_nonzeros(bins: int = 128) -> int:
    """Nonzero weights of Kaldi's ``bins`` triangular mel banks: triangles
    on the 1127 ln(1 + f / 700) scale, their edges evenly spaced in mel
    from ``LOW_HZ`` to ``HIGH_HZ``, over the FFT's bins below Nyquist (whose
    weight Kaldi leaves zero)."""
    mel = lambda f: 1127.0 * math.log1p(f / 700.0)  # noqa: E731
    lo, hi = mel(LOW_HZ), mel(HIGH_HZ)
    delta = (hi - lo) / (bins + 1)
    return sum(lo + b * delta < mel(RATE / FFT * k) < lo + (b + 2) * delta
               for k in range(FFT // 2) for b in range(bins))


def fbank_flops(n_frames: int, bins: int = 128) -> float:
    bins_fft = FFT // 2 + 1
    return n_frames * (4 * FRAME + FRAME + 2.5 * FFT * math.log2(FFT)
                       + 3 * bins_fft + 2 * mel_nonzeros(bins))


def fbank_bound_s(n_samples: int, config: dict, peak: dict) -> float:
    """The least time of one chunk's fbank: its flops at the f32 peak (the
    fbank runs in f32 under every configuration) or its bytes at the
    memory's, the larger."""
    sizes, hop = config['sizes'], config['framehop_prop']
    n = frames(n_samples, sizes, hop)
    wire = 2 if config['transfer_dtype'] == 'int16' else 4
    nbytes = (padded_samples(n_samples, sizes, hop) * wire
              + n * sizes['input_fdim'] * 4)
    return max(fbank_flops(n, sizes['input_fdim']) / peak['f32'],
               nbytes / peak['bytes'])


def attention_flops(sizes: dict) -> float:
    """QK^T and PV of one window, every block and head."""
    t = tokens(sizes)
    return 4.0 * t * t * sizes['embed_dim'] * sizes['depth']


def attention_bound_s(n_windows: int, sizes: dict, peak: dict) -> float:
    """The least time of ``n_windows`` windows' attention in bf16: the
    flops at the bf16 peak or q, k, v and o at the memory's, the larger."""
    nbytes = 4.0 * tokens(sizes) * sizes['embed_dim'] * 2 * sizes['depth']
    return n_windows * max(attention_flops(sizes) / peak['bf16'],
                           nbytes / peak['bytes'])


def linear_flops(sizes: dict) -> float:
    """One window's products other than attention's."""
    t, c, m = tokens(sizes), sizes['embed_dim'], sizes['mlp_dim']
    k = sizes['patch_size']
    patch = 2.0 * (t - 2) * k * k * c
    block = 2.0 * t * c * 3 * c + 2.0 * t * c * c + 4.0 * t * c * m
    return patch + sizes['depth'] * block + 2.0 * c * sizes['label_dim']


def chunk_s_at_peak(n_samples: int, config: dict, peak: dict) -> float:
    """One chunk's work, each part at its engine's peak: the fbank at f32,
    the products at bf16 under the bf16 function (else f32)."""
    sizes, hop = config['sizes'], config['framehop_prop']
    w = windows(n_samples, sizes, hop)
    products = w * (linear_flops(sizes) + attention_flops(sizes))
    rate = peak['bf16' if config['reference_function'] == 'bf16' else 'f32']
    return (fbank_flops(frames(n_samples, sizes, hop), sizes['input_fdim'])
            / peak['f32'] + products / rate)
