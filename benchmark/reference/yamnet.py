"""The plain reference of the YAMNet classify, in PyTorch float32.

Written from the published YAMNet (tensorflow/models research/audioset/
yamnet: ``params.py``, ``features.py``, ``yamnet.py``) and the buzzdetect
bundle's head, not from the program under test: it imports nothing of the
program and takes nothing the program made. It reads the bundle's raw
arrays (``model.npz``: kernels, BatchNorm statistics, the head) and the
same int16 samples the harness hands the program, and works out the rest
itself:

* the wire: int16 samples / 32768;
* the log-mel: 25 ms periodic-Hann frames at a 10 ms hop, a 512-point real
  FFT (``torch.fft.rfft``), magnitude, a 64-band HTK mel matrix over
  125-7500 Hz, log(mel + 0.001), 96-frame patches at framehop 1;
* the network: layer 1 a 3x3 stride-2 conv to 32 channels, then 13
  depthwise-separable layers, each conv with BatchNorm folded (centre only,
  eps 1e-4) and ReLU, TF-SAME padding, global average pooling;
* the head: one dense layer of 13 classes.

Products run in float32 with TF32 off. ``precision`` names the function to
compute:

* ``'f32'``: exact f32 (the ``yamnet_general_v3.f32`` configuration);
* ``'bf16'``: the bf16 configuration's function: layer 1's patches, kernel
  and output rounded to bf16; each pointwise product's activation and
  weight rounded to bf16, accumulated in f32; depthwise, biases, pooling,
  the frontend and the head in f32;
* ``'tf32'``: the control below f32: every product's operands (the mel
  product, layer 1, depthwise, pointwise, head) rounded to TF32, as TF32
  tensor cores take them;
* ``'fp8'``: the control below bf16: the bf16 function with e4m3 fp8
  (per-tensor scale to 448) wherever it rounds to bf16.
"""

import os

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
WINDOW = 400            # 25 ms
HOP = 160               # 10 ms
FFT = 512
MEL_BANDS = 64
MEL_LO, MEL_HI = 125.0, 7500.0
LOG_OFFSET = 0.001
PATCH_FRAMES = 96       # 0.96 s
PATCH_SAMPLES = PATCH_FRAMES * HOP
# one patch needs its 0.96 s plus the rest of its last 25 ms window
MIN_SAMPLES = int((0.96 + 0.025 - 0.010) * SAMPLE_RATE)
BN_EPS = 1e-4
# (kind, stride, filters): YAMNet's _YAMNET_LAYER_DEFS
LAYERS = (('conv', 2, 32), ('sep', 1, 64), ('sep', 2, 128), ('sep', 1, 128),
          ('sep', 2, 256), ('sep', 1, 256), ('sep', 2, 512), ('sep', 1, 512),
          ('sep', 1, 512), ('sep', 1, 512), ('sep', 1, 512), ('sep', 1, 512),
          ('sep', 2, 1024), ('sep', 1, 1024))
PRECISIONS = ('f32', 'bf16', 'tf32', 'fp8')
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def n_patches(n_samples: int) -> int:
    """Patches of a chunk of ``n_samples`` at framehop 1: one for the first
    0.96 s window, one per further whole or partial 0.96 s, none that would
    start at or past the last sample."""
    extra = max(0, n_samples - MIN_SAMPLES)
    n = 1 + -(-extra // PATCH_SAMPLES)
    if n_samples > 0:
        n = min(n, (n_samples - 1) // PATCH_SAMPLES + 1)
    return max(n, 1)


def padded_samples(n_samples: int) -> int:
    """The chunk zero-padded to its patches' whole extent."""
    return MIN_SAMPLES + (n_patches(n_samples) - 1) * PATCH_SAMPLES


def mel_matrix() -> np.ndarray:
    """(257, 64) HTK mel weights, as ``tf.signal.linear_to_mel_weight_matrix``
    builds them (the DC bin's row zero)."""
    def mel(f):
        return 1127.0 * np.log1p(np.asarray(f, np.float64) / 700.0)
    bins = FFT // 2 + 1
    freqs = mel(np.linspace(0.0, SAMPLE_RATE / 2.0, bins)[1:])[:, None]
    edges = np.linspace(mel(MEL_LO), mel(MEL_HI), MEL_BANDS + 2)
    lo, mid, hi = edges[None, :-2], edges[None, 1:-1], edges[None, 2:]
    w = np.maximum(0.0, np.minimum((freqs - lo) / (mid - lo),
                                   (hi - freqs) / (hi - mid)))
    return np.pad(w, [[1, 0], [0, 0]]).astype(np.float32)


def fold(arrays: dict) -> dict:
    """The bundle's raw arrays -> {name: tensor}: every conv kernel with its
    BatchNorm folded in f32 (kernel * s, beta - mean * s, s = 1/sqrt(var
    + eps)), HWIO, and the head."""
    out = {}
    for i, (kind, _stride, _f) in enumerate(LAYERS, start=1):
        convs = ['conv'] if kind == 'conv' else ['depthwise_conv',
                                                 'pointwise_conv']
        for c in convs:
            key = f'layer{i}/{c}'
            raw = {p: np.asarray(arrays[f'yamnet_raw/{key}/{p}'], np.float32)
                   for p in ('kernel', 'bn_beta', 'bn_mean', 'bn_var')}
            s = np.float32(1.0) / np.sqrt(raw['bn_var'] + np.float32(BN_EPS))
            out[f'{key}/kernel'] = torch.from_numpy(raw['kernel'] * s)
            out[f'{key}/bias'] = torch.from_numpy(
                raw['bn_beta'] - raw['bn_mean'] * s)
    out['head/kernel'] = torch.from_numpy(
        np.asarray(arrays['head/kernel'], np.float32))
    out['head/bias'] = torch.from_numpy(
        np.asarray(arrays['head/bias'], np.float32))
    return out


def load_bundle(path: str, device) -> dict:
    """Folded weights of the bundle at ``path`` on ``device``."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k.startswith(('yamnet_raw/',
                                                            'head/'))}
    return {k: v.to(device) for k, v in fold(arrays).items()}


# --- rounding ----------------------------------------------------------------

def _tf32(x):
    """Round to TF32 (10 mantissa bits), to nearest, ties away from zero."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _fp8(x):
    """e4m3 fp8 with one per-tensor scale that takes the largest magnitude
    to 448, as an fp8 path scales its tensors."""
    amax = x.abs().max()
    scale = torch.where(amax > 0, 448.0 / amax, torch.ones_like(amax))
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def _keep(x):
    return x


def _roundings(precision):
    """(every product's operands, layer 1 and pointwise rounding): what
    each function rounds where."""
    if precision not in PRECISIONS:
        raise ValueError(f'precision must be one of {PRECISIONS}')
    return {'f32': (_keep, _keep), 'tf32': (_tf32, _keep),
            'bf16': (_keep, _bf16), 'fp8': (_keep, _fp8)}[precision]


# --- the classify -------------------------------------------------------------

def _pad_same(x, stride):
    """TF-SAME padding of an NCHW tensor for a 3x3 kernel."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        out = -(-n // stride)
        total = max((out - 1) * stride + 3 - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def log_mel_patches(wav: torch.Tensor, op=_keep) -> torch.Tensor:
    """(B, L) padded f32 waveforms -> (B, P, 96, 64) log-mel patches."""
    frames = wav.unfold(-1, WINDOW, HOP)                     # (B, T, 400)
    n = torch.arange(WINDOW, dtype=torch.float64, device=wav.device)
    hann = (0.5 - 0.5 * torch.cos(2 * np.pi * n / WINDOW)).to(torch.float32)
    mag = torch.fft.rfft(frames * hann, n=FFT).abs()
    mel = torch.from_numpy(mel_matrix()).to(wav.device)
    spec = torch.log(op(mag) @ op(mel) + LOG_OFFSET)         # (B, T, 64)
    p = (spec.shape[1] - PATCH_FRAMES) // PATCH_FRAMES + 1
    return spec[:, :p * PATCH_FRAMES].reshape(wav.shape[0], p, PATCH_FRAMES,
                                              MEL_BANDS)


def embed(w: dict, patches: torch.Tensor, precision='f32') -> torch.Tensor:
    """(N, 96, 64) patches -> (N, 1024) embeddings."""
    op, narrow = _roundings(precision)
    k = w['layer1/conv/kernel'].permute(3, 2, 0, 1)          # OIHW
    x = _pad_same(narrow(patches)[:, None], 2)
    x = narrow(torch.relu(F.conv2d(op(x), op(narrow(k)), stride=2)
                          + w['layer1/conv/bias'][:, None, None]))
    for i, (_kind, stride, _f) in enumerate(LAYERS[1:], start=2):
        dk = w[f'layer{i}/depthwise_conv/kernel']            # (3, 3, 1, C)
        c = dk.shape[3]
        x = F.conv2d(op(_pad_same(x, stride)),
                     op(dk.permute(3, 2, 0, 1).contiguous()), stride=stride,
                     groups=c)
        x = torch.relu(x + w[f'layer{i}/depthwise_conv/bias'][:, None, None])
        pk = w[f'layer{i}/pointwise_conv/kernel'][0, 0]     # (C, F)
        b, _, h, wd = x.shape
        flat = x.permute(0, 2, 3, 1).reshape(-1, c)
        y = op(narrow(flat)) @ op(narrow(pk))
        y = torch.relu(y + w[f'layer{i}/pointwise_conv/bias'])
        x = y.reshape(b, h, wd, -1).permute(0, 3, 1, 2)
    return x.mean(dim=(2, 3))


def classify(w: dict, wire: np.ndarray, precision='f32',
             block: int = 64) -> np.ndarray:
    """One chunk's int16 wire samples -> (n_patches, 13) scores, computed
    ``block`` patches at a time on the weights' device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    op, _ = _roundings(precision)
    device = w['head/kernel'].device
    n = len(wire)
    padded = np.zeros(padded_samples(n), np.float32)
    padded[:n] = np.asarray(wire, np.int16).astype(np.float32) / 32768.0
    with torch.inference_mode():
        wav = torch.from_numpy(padded).to(device)[None]
        patches = log_mel_patches(wav, op)[0]
        outs = []
        for lo in range(0, len(patches), block):
            e = embed(w, patches[lo:lo + block], precision)
            outs.append(op(e) @ op(w['head/kernel']) + w['head/bias'])
        scores = torch.cat(outs).cpu().numpy()
    return scores[:n_patches(n)]


def scores(config: dict, inputs: dict, device, precision: str) -> dict:
    """{key: (n_patches, 13) scores} for {key: int16 samples}: the bundle
    ``models/<model>/model.npz`` of this checkout, ``precision``'s function,
    one chunk at a time on ``device``."""
    w = load_bundle(os.path.join(ROOT, 'models', config['model'],
                                 'model.npz'), device)
    return {k: classify(w, x, precision) for k, x in inputs.items()}
