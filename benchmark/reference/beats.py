"""The plain reference of BEATs (the fine-tuned AudioSet tagger), in PyTorch
float32.

Written from the paper (Chen et al. 2023, "BEATs: Audio Pre-Training with
Acoustic Tokenizers", arXiv:2212.09058) and its published code
(https://github.com/microsoft/unilm/tree/master/beats: ``BEATs.py``,
``backbone.py``; the fbank as ``torchaudio.compliance.kaldi.fbank``
computes it at its defaults), not from the program under test: it imports
nothing of the program and takes nothing the program made (beside its own
code it takes the Kaldi mel banks and the window count of
``reference/ast.py``). It reads the model directory's ``config_model.json``
(its ``sizes``, under the checkpoint ``cfg``'s names) and its weights,
``model.npz`` where one is present, else the seeded weights the file names
(``"weights": "seeded"``), made here by its own copy of the recipe: every
tensor N(0, 0.02^2), the relative-position bias table N(0, 1) and each
``grep_linear.weight`` N(0, 0.5^2), drawn in float64 from
``numpy.random.default_rng(SeedSequence([seed, crc32(name)]))`` and
rounded to float32; LayerNorm weights and ``grep_a`` 1; biases 0.

The classify of one chunk of int16 samples:

* the int16 values as they are (BEATs multiplies a waveform in [-1, 1] by
  2^15), zero-padded to whole windows (one window of ``input_tdim`` frames
  needs 400 + 160 (tdim - 1) samples; one more for each further window hop
  or part of one, none that would start at or past the last sample);
* the Kaldi fbank at torchaudio's defaults with 128 bins and a 10 ms shift:
  25 ms frames with ``snip_edges``, ``dither`` 0, each frame's own mean
  subtracted, pre-emphasis 0.97 (the first sample before itself), the Povey
  window (the symmetric Hann window to the 0.85), ``torch.fft.rfft`` of the
  frame zero-padded to 512, the power, Kaldi's 128 mel bands over 20-8000
  Hz, log(max(e, float32 eps)); then (x - 15.41663) / (2 x 6.55582);
* windows of ``input_tdim`` frames every ``framehop_prop`` of a window,
  each read as (time x 128 freq); ``F.conv2d`` 16 x 16 at stride 16 without
  bias, flattened to tokens (8 t + f), LayerNorm, the 512 -> 768
  projection;
* the convolutional position embedding: ``F.conv1d`` (kernel 128, padding
  64, 16 groups, bias; the weight-norm's g v / |v| as the model directory
  holds it, folded), its last output dropped, GELU, added; LayerNorm;
* 12 post-LN layers as ``TransformerSentenceEncoderLayer`` with
  ``deep_norm``: x = LN(x alpha + attn(x)), x = LN(x alpha + fc2(GELU(fc1(
  x)))), alpha = (2 x 12)^(1/4); the attention as ``MultiheadAttention``
  with ``gru_rel_pos``: q, k, v projections, the relative-position bucket
  of every (i, j) by the published formula from the one table of layer 0,
  the gate from ``grep_linear``'s 8 outputs of the query before scaling,
  summed by 4, sigmoid, a (b grep_a - 1) + 2, times the bias, added to q
  k^T / 8; softmax; ``out_proj``;
* ``predictor`` on every token, then the mean over the tokens: 527 logits
  (BEATs' sigmoid is left out, as the program leaves it).

Departures from the published pipeline, each also in the configuration's
``assumed``:

* the windows are contiguous 992-frame spans of the recording (the tokens
  of a 10 s clip), not 10 s clips;
* the published ``q / 32`` and ``(s - max) x 32`` shift each score row by a
  constant, which the softmax ignores: the plain softmax here.

Products run in float32 with TF32 off. ``precision`` names the function to
compute:

* ``'f32'``: exact f32;
* ``'bf16'``: every product's operands rounded to bf16 (the patch conv's
  input and kernel, the projection, the position convolution, q/k/v, q and
  k, the softmax's P and v, the attention's output and out_proj, fc1, fc2,
  the predictor; the gate reads the rounded q), sums in f32; everything
  else f32;
* ``'fp8'``: the control below bf16: e4m3 fp8 with a per-tensor scale
  wherever ``'bf16'`` rounds.

On the card it computes ``block`` windows at a time.
"""

import json
import math
import os
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.ast import _rounding, mel_banks, n_windows

FRAME = 400            # 25 ms
SHIFT = 160            # 10 ms
NFFT = 512
PREEMPHASIS = 0.97
POVEY = 0.85
FBANK_MEAN, FBANK_STD = 15.41663, 6.55582
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
REL_TABLE = 'encoder.layers.0.self_attn.relative_attention_bias.weight'


# --- the weights --------------------------------------------------------------

def names_and_shapes(s: dict) -> list:
    """[(name, shape)] of the published state dict for the sizes ``s``, the
    position convolution's weight-norm folded and the bias table once."""
    c, e = s['encoder_embed_dim'], s['embed_dim']
    ffn, h = s['encoder_ffn_embed_dim'], s['encoder_attention_heads']
    p = s['input_patch_size']
    out = [('post_extract_proj.weight', (c, e)),
           ('post_extract_proj.bias', (c,)),
           ('patch_embedding.weight', (e, 1, p, p)),
           ('encoder.pos_conv.0.weight', (c, c // s['conv_pos_groups'],
                                          s['conv_pos'])),
           ('encoder.pos_conv.0.bias', (c,))]
    for i in range(s['encoder_layers']):
        b = f'encoder.layers.{i}.'
        for proj in ('k_proj', 'v_proj', 'q_proj', 'out_proj'):
            out += [(f'{b}self_attn.{proj}.weight', (c, c)),
                    (f'{b}self_attn.{proj}.bias', (c,))]
        out += [(f'{b}self_attn.grep_linear.weight', (8, c // h)),
                (f'{b}self_attn.grep_linear.bias', (8,)),
                (f'{b}self_attn.grep_a', (1, h, 1, 1))]
        if i == 0:
            out.append((REL_TABLE, (s['num_buckets'], h)))
        out += [(f'{b}self_attn_layer_norm.weight', (c,)),
                (f'{b}self_attn_layer_norm.bias', (c,)),
                (f'{b}fc1.weight', (ffn, c)), (f'{b}fc1.bias', (ffn,)),
                (f'{b}fc2.weight', (c, ffn)), (f'{b}fc2.bias', (c,)),
                (f'{b}final_layer_norm.weight', (c,)),
                (f'{b}final_layer_norm.bias', (c,))]
    out += [('encoder.layer_norm.weight', (c,)),
            ('encoder.layer_norm.bias', (c,)),
            ('layer_norm.weight', (e,)), ('layer_norm.bias', (e,)),
            ('predictor.weight', (s['predictor_class'], c)),
            ('predictor.bias', (s['predictor_class'],))]
    return out


def seeded(s: dict, seed: int) -> dict:
    """The seeded weights (see the module's docstring)."""
    out = {}
    for name, shape in names_and_shapes(s):
        if name.endswith('layer_norm.weight') or name.endswith('grep_a'):
            out[name] = np.ones(shape, np.float32)
        elif name.endswith('.bias'):
            out[name] = np.zeros(shape, np.float32)
        else:
            std = 1.0 if name == REL_TABLE else (
                0.5 if name.endswith('grep_linear.weight') else 0.02)
            rng = np.random.default_rng(np.random.SeedSequence(
                [int(seed), zlib.crc32(name.encode())]))
            out[name] = (rng.standard_normal(shape) * std).astype(np.float32)
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


# --- the fbank ----------------------------------------------------------------

def fbank(wav: torch.Tensor, bins: int = 128) -> torch.Tensor:
    """(L,) f32 samples (int16 amplitudes) -> (frames, bins) normalised
    Kaldi fbank with the Povey window."""
    frames = wav.unfold(0, FRAME, SHIFT)
    frames = frames - frames.mean(dim=1, keepdim=True)
    before = F.pad(frames.unsqueeze(0), (1, 0), mode='replicate')[0, :, :-1]
    frames = frames - PREEMPHASIS * before
    window = torch.hann_window(FRAME, periodic=False, dtype=torch.float64,
                               device=wav.device).pow(POVEY)
    spectrum = torch.fft.rfft(frames * window.to(torch.float32), n=NFFT)
    power = spectrum.abs().pow(2.0)
    energies = power @ mel_banks(bins).to(wav.device)
    eps = torch.finfo(torch.float32).eps
    return (torch.clamp_min(energies, eps).log() - FBANK_MEAN) \
        / (2 * FBANK_STD)


# --- the network ----------------------------------------------------------------

def buckets(n: int, num_buckets: int, max_distance: int, device):
    """(n, n) relative-position buckets of memory j against context i, as
    ``MultiheadAttention._relative_positions_bucket`` (bidirectional)."""
    ctx = torch.arange(n, dtype=torch.long)[:, None]
    mem = torch.arange(n, dtype=torch.long)[None, :]
    rel = mem - ctx
    num_buckets //= 2
    out = (rel > 0).to(torch.long) * num_buckets
    rel = torch.abs(rel)
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    large = max_exact + (torch.log(rel.float() / max_exact)
                         / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).to(torch.long)
    large = torch.min(large, torch.full_like(large, num_buckets - 1))
    return (out + torch.where(is_small, rel, large)).to(device)


def layer(w: dict, s: dict, i: int, x: torch.Tensor, bias: torch.Tensor,
          op) -> torch.Tensor:
    """Post-LN layer ``i`` with deep norm on (B, T, C)."""
    b, t, c = x.shape
    heads = s['encoder_attention_heads']
    d = c // heads
    alpha = math.pow(2 * s['encoder_layers'], 0.25)
    eps = s.get('layer_norm_eps', 1e-5)
    p = f'encoder.layers.{i}.'
    a = p + 'self_attn.'
    xo = op(x)
    q, k, v = (F.linear(xo, op(w[f'{a}{n}_proj.weight']),
                        w[f'{a}{n}_proj.bias'])
               .view(b, t, heads, d).transpose(1, 2) for n in 'qkv')
    q, k, v = op(q), op(k), op(v)
    g = torch.sigmoid(F.linear(q, w[a + 'grep_linear.weight'],
                               w[a + 'grep_linear.bias'])
                      .view(b, heads, t, 2, 4).sum(-1))
    gate_a, gate_b = g.chunk(2, dim=-1)
    gate = gate_a * (gate_b * w[a + 'grep_a'] - 1.0) + 2.0
    scores = (q @ k.transpose(-2, -1)) * d ** -0.5 + gate * bias
    probs = scores.softmax(dim=-1)
    attn = (op(probs) @ v).transpose(1, 2).reshape(b, t, c)
    attn = F.linear(op(attn), op(w[a + 'out_proj.weight']),
                    w[a + 'out_proj.bias'])
    x = F.layer_norm(x * alpha + attn, (c,),
                     w[p + 'self_attn_layer_norm.weight'],
                     w[p + 'self_attn_layer_norm.bias'], eps)
    f = F.gelu(F.linear(op(x), op(w[p + 'fc1.weight']), w[p + 'fc1.bias']))
    f = F.linear(op(f), op(w[p + 'fc2.weight']), w[p + 'fc2.bias'])
    return F.layer_norm(x * alpha + f, (c,), w[p + 'final_layer_norm.weight'],
                        w[p + 'final_layer_norm.bias'], eps)


def encode(w: dict, s: dict, x: torch.Tensor, op) -> torch.Tensor:
    """(W, tdim, 128) fbank windows (time x freq) -> (W, classes) logits."""
    c, e = s['encoder_embed_dim'], s['embed_dim']
    eps = s.get('layer_norm_eps', 1e-5)
    ps = s['input_patch_size']
    feats = F.conv2d(op(x.unsqueeze(1)), op(w['patch_embedding.weight']),
                     stride=ps)
    feats = feats.reshape(feats.shape[0], feats.shape[1], -1).transpose(1, 2)
    feats = F.layer_norm(feats, (e,), w['layer_norm.weight'],
                         w['layer_norm.bias'], eps)
    x = F.linear(op(feats), op(w['post_extract_proj.weight']),
                 w['post_extract_proj.bias'])
    conv = F.conv1d(op(x.transpose(1, 2)), op(w['encoder.pos_conv.0.weight']),
                    w['encoder.pos_conv.0.bias'], padding=s['conv_pos'] // 2,
                    groups=s['conv_pos_groups'])[:, :, :-1]
    x = x + F.gelu(conv).transpose(1, 2)
    x = F.layer_norm(x, (c,), w['encoder.layer_norm.weight'],
                     w['encoder.layer_norm.bias'], eps)
    t = x.shape[1]
    bias = w[REL_TABLE][buckets(t, s['num_buckets'], s['max_distance'],
                                x.device)].permute(2, 0, 1)
    for i in range(s['encoder_layers']):
        x = layer(w, s, i, x, bias, op)
    logits = F.linear(op(x), op(w['predictor.weight']), w['predictor.bias'])
    return logits.mean(dim=1)


def classify(w: dict, s: dict, wire: np.ndarray, framehop_prop: float = 1.0,
             precision: str = 'f32', block: int = 8) -> np.ndarray:
    """One chunk's int16 samples -> (windows, classes) scores, ``block``
    windows at a time on the weights' device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    op = _rounding(precision)
    device = w['predictor.weight'].device
    tdim = s['input_tdim']
    hop = max(1, int(round(tdim * framehop_prop)))
    count = n_windows(len(wire), tdim, hop)
    padded = np.zeros(FRAME + ((count - 1) * hop + tdim - 1) * SHIFT,
                      np.float32)
    padded[:len(wire)] = np.asarray(wire, np.int16).astype(np.float32)
    with torch.inference_mode():
        fb = fbank(torch.from_numpy(padded).to(device), s['input_fdim'])
        starts = [i * hop for i in range(count)]
        outs = []
        for lo in range(0, count, block):
            x = torch.stack([fb[a:a + tdim] for a in starts[lo:lo + block]])
            outs.append(encode(w, s, x, op))
        return torch.cat(outs).cpu().numpy()


def scores(config: dict, inputs: dict, device, precision: str) -> dict:
    """{key: (windows, classes) scores} for {key: int16 samples}: the model
    directory ``models/<model>`` of this checkout, ``precision``'s function,
    one chunk at a time on ``device``."""
    s, w = load_weights(os.path.join(ROOT, 'models', config['model']),
                        device)
    hop = config.get('framehop_prop', 1.0)
    block = 16 if torch.device(device).type == 'cuda' else 2
    return {k: classify(w, s, x, hop, precision, block)
            for k, x in inputs.items()}
