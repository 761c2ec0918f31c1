"""The plain reference of the Audio Spectrogram Transformer, in PyTorch
float32.

Written from the paper (Gong, Chung and Glass 2021, arXiv:2104.01778) and
its published code (https://github.com/YuanGongND/ast: ``src/models/
ast_models.py``, ``src/dataloader.py``; the fbank as ``torchaudio.
compliance.kaldi.fbank`` computes it; the blocks as timm's DeiT), not from
the program under test: it imports nothing of the program and takes
nothing the program made. It reads the model directory's
``config_model.json`` (its ``sizes``) and its weights, ``model.npz`` where
one is present, else the seeded weights the file names (``"weights":
"seeded"``), made here by its own copy of the recipe: every tensor
N(0, 0.02^2) drawn in float64 from ``numpy.random.default_rng(
SeedSequence([seed, crc32(name)]))`` and rounded to float32, LayerNorm
weights 1, biases 0.

The classify of one chunk of int16 samples:

* int16 / 32768, zero-padded to whole windows (one window of 1,024 frames
  needs 400 + 1,023 x 160 samples; one more window for each further window
  hop or part of one, none that would start at or past the last sample);
* the Kaldi fbank with AST's settings (``htk_compat``, ``use_energy``
  off, ``window_type='hanning'``, 128 bins, ``dither`` 0, a 10 ms shift):
  25 ms frames at a 10 ms hop with ``snip_edges``, each frame's own mean
  subtracted, pre-emphasis 0.97 (the first sample before itself), a
  symmetric Hann window, ``torch.fft.rfft`` of the frame zero-padded to
  512, the power, 128 triangular mel bands on the 1127 ln(1 + f / 700)
  scale over 20-8000 Hz (256 bins, the Nyquist column zero), log(max(e,
  float32 eps)); then (x + 4.2677393) / (2 x 4.5689974);
* windows of 1,024 frames every ``framehop_prop`` of a window, each read as
  (128 freq x 1,024 time); a 16 x 16 conv at stride 10 (``F.conv2d``):
  12 x 101 patches; the cls and distillation tokens before them; the
  position embedding added;
* 12 pre-LN blocks (LayerNorm eps 1e-6; 12 heads of 64, q k^T / 8, softmax,
  no mask; MLP 3,072 with erf GELU); the final LayerNorm; the mean of the
  two tokens; LayerNorm (eps 1e-5) and the 527-class product.

Departures from the published pipeline, each also in the configuration's
``assumed``:

* the windows are contiguous 10.24 s of the recording, not 10 s clips
  whose 998 frames are zero-padded to 1,024;
* the whole clip's mean, which AST's loader subtracts before the fbank, is
  left out: each frame's own mean subtraction makes it a no-op.

Products run in float32 with TF32 off. ``precision`` names the function to
compute:

* ``'f32'``: exact f32;
* ``'bf16'``: every product's operands rounded to bf16 (the patch conv's
  input and kernel, qkv, q and k, the softmax's P and v, the attention's
  output and proj, fc1, fc2, the head), sums in f32; everything else f32;
* ``'fp8'``: the control below bf16: e4m3 fp8 with a per-tensor scale
  (the largest magnitude to 448) wherever ``'bf16'`` rounds.

On the card it computes ``block`` windows at a time, so that the scores of
every head fit.
"""

import json
import os
import zlib

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
FRAME = 400            # 25 ms
SHIFT = 160            # 10 ms
NFFT = 512
LOW_HZ, HIGH_HZ = 20.0, 8000.0
PREEMPHASIS = 0.97
NORM_MEAN, NORM_STD = -4.2677393, 4.5689974
PRECISIONS = ('f32', 'bf16', 'fp8')
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# --- the weights --------------------------------------------------------------

def names_and_shapes(s: dict) -> list:
    """[(name, shape)] of the published state dict (``module.`` left out)
    for the sizes ``s``."""
    c, mlp = s['embed_dim'], s['mlp_dim']
    f = (s['input_fdim'] - s['patch_size']) // s['fstride'] + 1
    t = (s['input_tdim'] - s['patch_size']) // s['tstride'] + 1
    out = [('v.cls_token', (1, 1, c)), ('v.dist_token', (1, 1, c)),
           ('v.pos_embed', (1, f * t + 2, c)),
           ('v.patch_embed.proj.weight', (c, 1, s['patch_size'],
                                          s['patch_size'])),
           ('v.patch_embed.proj.bias', (c,))]
    for i in range(s['depth']):
        out += [(f'v.blocks.{i}.{n}', shape) for n, shape in (
            ('norm1.weight', (c,)), ('norm1.bias', (c,)),
            ('attn.qkv.weight', (3 * c, c)), ('attn.qkv.bias', (3 * c,)),
            ('attn.proj.weight', (c, c)), ('attn.proj.bias', (c,)),
            ('norm2.weight', (c,)), ('norm2.bias', (c,)),
            ('mlp.fc1.weight', (mlp, c)), ('mlp.fc1.bias', (mlp,)),
            ('mlp.fc2.weight', (c, mlp)), ('mlp.fc2.bias', (c,)))]
    out += [('v.norm.weight', (c,)), ('v.norm.bias', (c,)),
            ('mlp_head.0.weight', (c,)), ('mlp_head.0.bias', (c,)),
            ('mlp_head.1.weight', (s['label_dim'], c)),
            ('mlp_head.1.bias', (s['label_dim'],))]
    return out


def seeded(s: dict, seed: int) -> dict:
    """The seeded weights: N(0, 0.02^2) from default_rng(SeedSequence([seed,
    crc32(name)])) in float64, rounded to f32; LayerNorm weights 1; biases 0."""
    out = {}
    for name, shape in names_and_shapes(s):
        layer_norm = ('norm' in name.split('.')[-2]
                      or name.startswith('mlp_head.0.'))
        if name.endswith('.bias'):
            out[name] = np.zeros(shape, np.float32)
        elif layer_norm:
            out[name] = np.ones(shape, np.float32)
        else:
            rng = np.random.default_rng(np.random.SeedSequence(
                [int(seed), zlib.crc32(name.encode())]))
            out[name] = (rng.standard_normal(shape) * 0.02).astype(np.float32)
    return out


def load_weights(dir_model: str, device):
    """(sizes, {name: f32 tensor on ``device``}) of a model directory."""
    with open(os.path.join(dir_model, 'config_model.json')) as f:
        config = json.load(f)
    s = config['sizes']
    path = os.path.join(dir_model, 'model.npz')
    if os.path.exists(path):
        with np.load(path) as z:
            arrays = {name: z[name] for name, _ in names_and_shapes(s)}
    elif config.get('weights') == 'seeded':
        arrays = seeded(s, config['seed'])
    else:
        raise FileNotFoundError(f'{dir_model}: no model.npz and no seed')
    return s, {k: torch.from_numpy(np.asarray(v, np.float32)).to(device)
               for k, v in arrays.items()}


# --- rounding -----------------------------------------------------------------

def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _fp8(x):
    """e4m3 fp8 with one per-tensor scale that takes the largest magnitude
    to 448."""
    amax = x.abs().max()
    scale = torch.where(amax > 0, 448.0 / amax, torch.ones_like(amax))
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def _rounding(precision):
    if precision not in PRECISIONS:
        raise ValueError(f'precision must be one of {PRECISIONS}')
    return {'f32': lambda x: x, 'bf16': _bf16, 'fp8': _fp8}[precision]


# --- the fbank ----------------------------------------------------------------

def mel_banks(bins: int) -> torch.Tensor:
    """(NFFT / 2 + 1, bins) Kaldi mel banks, the Nyquist row zero."""
    def mel(f):
        return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)
    lo, hi = mel(LOW_HZ), mel(HIGH_HZ)
    delta = (hi - lo) / (bins + 1)
    m = mel(np.arange(NFFT // 2) * SAMPLE_RATE / NFFT)[:, None]
    b = np.arange(bins)[None, :]
    left, center, right = lo + b * delta, lo + (b + 1) * delta, \
        lo + (b + 2) * delta
    up = (m - left) / (center - left)
    down = (right - m) / (right - center)
    banks = np.maximum(0.0, np.minimum(up, down))
    return torch.from_numpy(np.concatenate(
        [banks, np.zeros((1, bins))]).astype(np.float32))


def fbank(wav: torch.Tensor, bins: int) -> torch.Tensor:
    """(L,) f32 samples -> (frames, bins) normalised Kaldi fbank."""
    frames = wav.unfold(0, FRAME, SHIFT)
    frames = frames - frames.mean(dim=1, keepdim=True)
    before = F.pad(frames.unsqueeze(0), (1, 0), mode='replicate')[0, :, :-1]
    frames = frames - PREEMPHASIS * before
    window = torch.hann_window(FRAME, periodic=False, dtype=torch.float64,
                               device=wav.device).to(torch.float32)
    spectrum = torch.fft.rfft(frames * window, n=NFFT)
    power = spectrum.abs().pow(2.0)
    energies = power @ mel_banks(bins).to(wav.device)
    eps = torch.finfo(torch.float32).eps
    return (torch.clamp_min(energies, eps).log() - NORM_MEAN) / (NORM_STD * 2)


def n_windows(n_samples: int, tdim: int, hop: int) -> int:
    """Windows of a chunk: the first, one per further hop or part of one,
    none starting at or past the last sample."""
    first = FRAME + (tdim - 1) * SHIFT
    step = hop * SHIFT
    n = 1 + max(0, -(-(n_samples - first) // step))
    return max(1, min(n, (n_samples - 1) // step + 1))


# --- the network ----------------------------------------------------------------

def encode(w: dict, s: dict, x: torch.Tensor, op) -> torch.Tensor:
    """(W, 128, tdim) fbank windows (freq x time) -> (W, classes) logits."""
    c, heads = s['embed_dim'], s['num_heads']
    d = c // heads
    eps = s['layer_norm_eps']
    x = F.conv2d(op(x.unsqueeze(1)), op(w['v.patch_embed.proj.weight']),
                 w['v.patch_embed.proj.bias'],
                 stride=(s['fstride'], s['tstride']))
    x = x.flatten(2).transpose(1, 2)
    b = x.shape[0]
    x = torch.cat([w['v.cls_token'].expand(b, -1, -1),
                   w['v.dist_token'].expand(b, -1, -1), x], dim=1)
    x = x + w['v.pos_embed']
    n = x.shape[1]
    for i in range(s['depth']):
        p = f'v.blocks.{i}.'
        h = F.layer_norm(x, (c,), w[p + 'norm1.weight'], w[p + 'norm1.bias'],
                         eps)
        qkv = F.linear(op(h), op(w[p + 'attn.qkv.weight']),
                       w[p + 'attn.qkv.bias'])
        q, k, v = qkv.reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)
        attn = (op(q) @ op(k).transpose(-2, -1)) * (d ** -0.5)
        attn = attn.softmax(dim=-1)
        a = (op(attn) @ op(v)).transpose(1, 2).reshape(b, n, c)
        x = x + F.linear(op(a), op(w[p + 'attn.proj.weight']),
                         w[p + 'attn.proj.bias'])
        h = F.layer_norm(x, (c,), w[p + 'norm2.weight'], w[p + 'norm2.bias'],
                         eps)
        h = F.gelu(F.linear(op(h), op(w[p + 'mlp.fc1.weight']),
                            w[p + 'mlp.fc1.bias']))
        x = x + F.linear(op(h), op(w[p + 'mlp.fc2.weight']),
                         w[p + 'mlp.fc2.bias'])
    x = F.layer_norm(x, (c,), w['v.norm.weight'], w['v.norm.bias'], eps)
    x = (x[:, 0] + x[:, 1]) / 2
    x = F.layer_norm(x, (c,), w['mlp_head.0.weight'], w['mlp_head.0.bias'],
                     s['head_layer_norm_eps'])
    return F.linear(op(x), op(w['mlp_head.1.weight']), w['mlp_head.1.bias'])


def classify(w: dict, s: dict, wire: np.ndarray, framehop_prop: float = 1.0,
             precision: str = 'f32', block: int = 8) -> np.ndarray:
    """One chunk's int16 samples -> (windows, classes) scores, ``block``
    windows at a time on the weights' device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    op = _rounding(precision)
    device = w['v.pos_embed'].device
    tdim = s['input_tdim']
    hop = max(1, int(round(tdim * framehop_prop)))
    count = n_windows(len(wire), tdim, hop)
    padded = np.zeros(FRAME + ((count - 1) * hop + tdim - 1) * SHIFT,
                      np.float32)
    padded[:len(wire)] = np.asarray(wire, np.int16).astype(np.float32) \
        / 32768.0
    with torch.inference_mode():
        fb = fbank(torch.from_numpy(padded).to(device), s['input_fdim'])
        starts = [i * hop for i in range(count)]
        outs = []
        for lo in range(0, count, block):
            x = torch.stack([fb[a:a + tdim].T for a in starts[lo:lo + block]])
            outs.append(encode(w, s, x, op))
        return torch.cat(outs).cpu().numpy()


def scores(config: dict, inputs: dict, device, precision: str) -> dict:
    """{key: (windows, classes) scores} for {key: int16 samples}: the model
    directory ``models/<model>`` of this checkout, ``precision``'s function,
    one chunk at a time on ``device``."""
    s, w = load_weights(os.path.join(ROOT, 'models', config['model']),
                        device)
    hop = config.get('framehop_prop', 1.0)
    block = 8 if torch.device(device).type == 'cuda' else 2
    return {k: classify(w, s, x, hop, precision, block)
            for k, x in inputs.items()}

