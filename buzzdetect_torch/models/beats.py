"""BEATs (the fine-tuned AudioSet tagger) on the port's chunk path.

Chen et al. 2023, "BEATs: Audio Pre-Training with Acoustic Tokenizers"
(arXiv:2212.09058, https://github.com/microsoft/unilm/tree/master/beats:
``BEATs.py``, ``backbone.py``); the "Fine-tuned BEATs_iter3+ (AS2M)"
checkpoint's sizes (``BEATsConfig``):

* the wire's raw int16 amplitudes (BEATs multiplies the waveform by 2^15)
  -> the Kaldi fbank at torchaudio's defaults (``ops/logmel.BEATS_FBANK``:
  128 bins a 10 ms frame, the Povey window, BEATs' normalisation), once a
  chunk, on the card one launch of the fused log-mel kernel;
* windows of ``input_tdim`` frames (992 = 62 x 16: the 496 tokens of a
  10 s clip's 998 frames, whose last 6 frames feed no patch), every
  ``framehop_prop`` of a window snapped to whole frames, views of the
  chunk's fbank read as (time x freq);
* the patch embedding: a 16 x 16 conv at stride 16 without bias, token n =
  8 t + f, as one product of the gathered patches; LayerNorm(512); the
  512 -> 768 projection;
* the position embedding: x += GELU(conv1d(x)), 768 -> 768, kernel 128,
  padding 64, 16 groups, with bias, the last of its T + 1 outputs dropped
  (its weight-norm folded when a checkpoint is converted,
  ``models/convert.beats_npz_from_state_dict``); then LayerNorm;
* 12 post-LN blocks with DeepNet's residual scale alpha = (2 x 12)^(1/4):
  x = LN1(alpha x + out_proj(attn(x))), x = LN2(alpha x + fc2(GELU(fc1(x))));
  q, k and v 768 -> 768 with bias, one product of their stacked weights;
  12 heads of 64, scale 1/8; each score plus g_ih bias_h[j - i], where
  bias_h[d] = E[bucket(d), h] from the one (320 x 12) table every block
  shares (``relative_buckets``: the published bucketing) and the gate g_ih
  = u0 (u1 a_h - 1) + 2, (u0, u1) = sigmoid(G q_ih + c), from the block's
  own ``grep_linear`` (its 8 rows and biases summed in groups of 4: G, c)
  and ``grep_a`` (a), q the query before scaling (``ops/attention.
  attention_relpos``, one launch a block); MLP 3072, erf GELU; LayerNorm
  eps 1e-5 throughout;
* the head: ``predictor`` (768 -> 527) of the tokens' mean, which is the
  mean of its product on every token: 527 logits a window (BEATs' sigmoid
  after it is left to the caller, as AST's path leaves it).

The published ``q / 32`` and ``(s - max) x 32`` shift each score row by a
constant, which the softmax ignores: the port writes the plain softmax.

Parameters (``param_shapes``) carry the published state-dict's names
(``encoder.layers.3.self_attn.q_proj.weight``, ...), the position
convolution's as one folded ``encoder.pos_conv.0.weight`` and the bias
table once, as layer 0's. Without a checkpoint ``seeded_params`` makes them
from a seed by AST's recipe (``models/ast.py``: N(0, 0.02^2) from
``default_rng(SeedSequence([seed, crc32(name)]))``, LayerNorm weights 1,
biases 0) with three exceptions, so that no mechanism of the block vanishes
inside the tests' tolerances: the bias table is drawn at ``REL_STD`` (a
bias of about the scores' own spread), ``grep_linear`` at ``GREP_STD`` (a
gate that moves over most of its range across tokens), and ``grep_a`` is
its published initial value, 1.

Precision: ``compute_dtype`` float32 is exact f32 (TF32 off); bfloat16
gives every product (patches, the projection, the position convolution,
q/k/v, QK^T, PV, out_proj, fc1, fc2, the head) bf16 operands and f32
accumulation, and keeps the residual stream, LayerNorm statistics, softmax,
GELU, the bias and the gate in f32; the gate reads the bf16 q. The position
convolution is cuDNN's bf16 convolution on the card, one call a group,
whose output is bf16 (the f32 sum rounded once); the CPU rounds it the
same way. On the
card each product is cuBLAS's with an f32 output, and what follows it one
pass of ``ops/epilogue.py``: q/k/v's bias and bf16 rounding, fc1's bias,
GELU and rounding, and after out_proj and fc2 the deep-norm post-LN
(``post_ln``), which writes the f32 residual stream and the next product's
bf16 operand at once.

Spans (``runtime/spans.py``) inside ``buzzdetect.classify``:
``buzzdetect.frontend`` (the fbank), and for each block of up to
``transformer.WINDOW_BLOCK`` windows ``buzzdetect.patch_embed``,
``buzzdetect.pos_conv``, ``buzzdetect.embed`` (the encoder, with a
``buzzdetect.attention`` around each attention launch and a
``buzzdetect.post_ln`` around each post-LN) and ``buzzdetect.head``.
"""

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from buzzdetect_torch.models.transformer import (
    FbankWindowClassifier, linear, operand, product, seeded_normal)
from buzzdetect_torch.ops import attention as attention_lib
from buzzdetect_torch.ops import epilogue, logmel
from buzzdetect_torch.runtime.spans import span

INIT_STD = 0.02
# the seeded bias table's and grep_linear's scales (see the docstring)
REL_STD = 1.0
GREP_STD = 0.5


@dataclass(frozen=True)
class BEATsConfig:
    """BEATs' sizes under the checkpoint ``cfg``'s names, and the port's
    window (``input_fdim`` bins x ``input_tdim`` frames) and LayerNorm eps.
    The flags name the variant the port runs, and no other is taken."""
    input_patch_size: int = 16
    embed_dim: int = 512
    conv_bias: bool = False
    encoder_layers: int = 12
    encoder_embed_dim: int = 768
    encoder_ffn_embed_dim: int = 3072
    encoder_attention_heads: int = 12
    layer_norm_first: bool = False
    deep_norm: bool = True
    conv_pos: int = 128
    conv_pos_groups: int = 16
    relative_position_embedding: bool = True
    num_buckets: int = 320
    max_distance: int = 800
    gru_rel_pos: bool = True
    predictor_class: int = 527
    input_fdim: int = 128
    input_tdim: int = 992
    layer_norm_eps: float = 1e-5

    # the flags of the one variant the port runs
    VARIANT = {'conv_bias': False, 'layer_norm_first': False,
               'deep_norm': True, 'relative_position_embedding': True,
               'gru_rel_pos': True}

    def __post_init__(self):
        for key, want in self.VARIANT.items():
            if getattr(self, key) != want:
                raise ValueError(f'BEATs {key}={getattr(self, key)}: the port '
                                 f'runs {key}={want} alone')
        p = self.input_patch_size
        if self.input_fdim % p or self.input_tdim % p:
            raise ValueError(f'a window of {self.input_fdim} x '
                             f'{self.input_tdim} is not whole {p} x {p} '
                             f'patches')
        if self.embed_dim == self.encoder_embed_dim:
            raise ValueError('the port takes the 512 -> 768 projection '
                             '(embed_dim != encoder_embed_dim)')

    @classmethod
    def from_sizes(cls, sizes: dict) -> 'BEATsConfig':
        """The configuration of a ``config_model.json``'s ``sizes``; keys it
        does not know are refused."""
        extra = set(sizes) - set(cls.__dataclass_fields__)
        if extra:
            raise ValueError(f'unknown BEATs sizes: {sorted(extra)}')
        return cls(**sizes)

    @property
    def head_dim(self) -> int:
        return self.encoder_embed_dim // self.encoder_attention_heads

    @property
    def width(self) -> int:
        """The encoder's width."""
        return self.encoder_embed_dim

    @property
    def label_dim(self) -> int:
        return self.predictor_class

    @property
    def alpha(self) -> float:
        """DeepNet's residual scale, (2 layers)^(1/4)."""
        return math.pow(2 * self.encoder_layers, 0.25)

    @property
    def tokens(self) -> int:
        p = self.input_patch_size
        return (self.input_tdim // p) * (self.input_fdim // p)


def param_shapes(cfg: BEATsConfig) -> dict:
    """{name: shape} of every parameter, in the published order."""
    c, e, f = cfg.encoder_embed_dim, cfg.embed_dim, cfg.encoder_ffn_embed_dim
    p, h = cfg.input_patch_size, cfg.encoder_attention_heads
    out = {'post_extract_proj.weight': (c, e), 'post_extract_proj.bias': (c,),
           'patch_embedding.weight': (e, 1, p, p),
           'encoder.pos_conv.0.weight': (c, c // cfg.conv_pos_groups,
                                         cfg.conv_pos),
           'encoder.pos_conv.0.bias': (c,)}
    for i in range(cfg.encoder_layers):
        b = f'encoder.layers.{i}.'
        for proj in ('k_proj', 'v_proj', 'q_proj', 'out_proj'):
            out.update({f'{b}self_attn.{proj}.weight': (c, c),
                        f'{b}self_attn.{proj}.bias': (c,)})
        out.update({f'{b}self_attn.grep_linear.weight': (8, cfg.head_dim),
                    f'{b}self_attn.grep_linear.bias': (8,),
                    f'{b}self_attn.grep_a': (1, h, 1, 1)})
        if i == 0:
            out[f'{b}self_attn.relative_attention_bias.weight'] = (
                cfg.num_buckets, h)
        out.update({f'{b}self_attn_layer_norm.weight': (c,),
                    f'{b}self_attn_layer_norm.bias': (c,),
                    f'{b}fc1.weight': (f, c), f'{b}fc1.bias': (f,),
                    f'{b}fc2.weight': (c, f), f'{b}fc2.bias': (c,),
                    f'{b}final_layer_norm.weight': (c,),
                    f'{b}final_layer_norm.bias': (c,)})
    out.update({'encoder.layer_norm.weight': (c,),
                'encoder.layer_norm.bias': (c,),
                'layer_norm.weight': (e,), 'layer_norm.bias': (e,),
                'predictor.weight': (cfg.predictor_class, c),
                'predictor.bias': (cfg.predictor_class,)})
    return out


REL_TABLE = 'encoder.layers.0.self_attn.relative_attention_bias.weight'


def seeded_params(cfg: BEATsConfig, seed: int) -> dict:
    """Every parameter from ``seed`` (see the module's docstring): N(0,
    0.02^2), the bias table N(0, ``REL_STD``^2), ``grep_linear``'s weights
    N(0, ``GREP_STD``^2), each drawn in float64 from ``default_rng(
    SeedSequence([seed, crc32(name)]))`` and rounded to f32; LayerNorm
    weights and ``grep_a`` 1; biases 0."""
    out = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith(('layer_norm.weight', 'grep_a')):
            out[name] = np.ones(shape, np.float32)
        elif name.endswith('.bias'):
            out[name] = np.zeros(shape, np.float32)
        else:
            std = (REL_STD if name == REL_TABLE else
                   GREP_STD if name.endswith('grep_linear.weight') else
                   INIT_STD)
            out[name] = seeded_normal(seed, name, shape, std)
    return out


def check_params(arrays: dict, cfg: BEATsConfig):
    """Raise unless ``arrays`` holds every parameter at its shape."""
    for name, shape in param_shapes(cfg).items():
        if name not in arrays:
            raise ValueError(f'BEATs parameters: {name} is missing')
        if tuple(arrays[name].shape) != shape:
            raise ValueError(f'BEATs parameters: {name} is '
                             f'{tuple(arrays[name].shape)}, expected {shape}')


# --- the relative position bias and the gate ----------------------------------

def relative_buckets(distance: torch.Tensor, num_buckets: int,
                     max_distance: int) -> torch.Tensor:
    """The bucket of each distance d = j - i (an int64 tensor), as
    ``MultiheadAttention._relative_positions_bucket`` computes it
    (bidirectional, in float32): num_buckets / 2 [d > 0] + |d| below
    num_buckets / 4, else min(num_buckets / 2 - 1, num_buckets / 4 +
    trunc(ln(|d| / (num_buckets / 4)) / ln(max_distance / (num_buckets /
    4)) (num_buckets / 4)))."""
    half = num_buckets // 2
    exact = half // 2
    a = distance.abs()
    # d = 0 takes log(0) here, and the exact branch below
    large = exact + (torch.log(a.float() / exact)
                     / math.log(max_distance / exact)
                     * (half - exact)).to(torch.long)
    large = torch.clamp(large, max=half - 1)
    return (distance > 0).to(torch.long) * half + torch.where(
        a < exact, a, large)


def bias_rows(table: np.ndarray, n: int, cfg: BEATsConfig) -> np.ndarray:
    """(heads, 2n - 1) f32: row h at column d + n - 1 is the bias table's
    value for bucket(d), d = -(n - 1) .. n - 1."""
    d = torch.arange(-(n - 1), n, dtype=torch.long)
    buckets = relative_buckets(d, cfg.num_buckets, cfg.max_distance).numpy()
    return np.ascontiguousarray(np.asarray(table, np.float32)[buckets].T)


def fold_gate(weight: np.ndarray, bias: np.ndarray, grep_a: np.ndarray):
    """A block's gate operand, G (2 x d) | c (2) | a (heads), f32:
    ``grep_linear``'s 8 rows and biases summed in groups of 4 (so that
    sigmoid(G q + c) is the published sigmoid of its 8 outputs summed by
    4), and ``grep_a``."""
    w = np.asarray(weight, np.float32)
    g = w.reshape(2, 4, w.shape[-1]).sum(axis=1, dtype=np.float32)
    c = np.asarray(bias, np.float32).reshape(2, 4).sum(axis=1,
                                                       dtype=np.float32)
    return np.concatenate([g.reshape(-1), c,
                           np.asarray(grep_a, np.float32).reshape(-1)])


# --- the forward pass ----------------------------------------------------------

def pack_params(arrays: dict, cfg: BEATsConfig, device, bf16: bool) -> dict:
    """The parameters on ``device`` as the forward pass takes them: each
    product's weight as an (out, in) matrix (q, k and v stacked), the
    position convolution's as one (C / groups, C / groups, 1, K)
    channels-last tensor a group, each in bf16 under bf16; per block the
    gate operand; the bias rows for the window's tokens; everything else
    f32."""
    def t(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device=device, dtype=dtype)
    wt = torch.bfloat16 if bf16 else torch.float32
    e = cfg.embed_dim
    p = {'patch': t(arrays['patch_embedding.weight'].reshape(e, -1), wt),
         'ln0.w': t(arrays['layer_norm.weight']),
         'ln0.b': t(arrays['layer_norm.bias']),
         'proj.w': t(arrays['post_extract_proj.weight'], wt),
         'proj.b': t(arrays['post_extract_proj.bias']),
         'pos.w': [t(wg[:, :, None, :], wt).contiguous(
             memory_format=torch.channels_last) for wg in np.split(
                 arrays['encoder.pos_conv.0.weight'], cfg.conv_pos_groups)],
         'pos.b': t(arrays['encoder.pos_conv.0.bias']),
         'ln.w': t(arrays['encoder.layer_norm.weight']),
         'ln.b': t(arrays['encoder.layer_norm.bias']),
         'head.w': t(arrays['predictor.weight'], wt),
         'head.b': t(arrays['predictor.bias']),
         'rel': t(bias_rows(arrays[REL_TABLE], cfg.tokens, cfg))}
    for i in range(cfg.encoder_layers):
        b = f'encoder.layers.{i}.'
        a = f'{b}self_attn.'
        p[f'{i}.qkv.w'] = t(np.concatenate([arrays[f'{a}{k}_proj.weight']
                                            for k in 'qkv']), wt)
        p[f'{i}.qkv.b'] = t(np.concatenate([arrays[f'{a}{k}_proj.bias']
                                            for k in 'qkv']))
        p[f'{i}.out.w'] = t(arrays[f'{a}out_proj.weight'], wt)
        p[f'{i}.out.b'] = t(arrays[f'{a}out_proj.bias'])
        p[f'{i}.gate'] = t(fold_gate(arrays[f'{a}grep_linear.weight'],
                                     arrays[f'{a}grep_linear.bias'],
                                     arrays[f'{a}grep_a']))
        for k in ('fc1', 'fc2'):
            p[f'{i}.{k}.w'] = t(arrays[f'{b}{k}.weight'], wt)
            p[f'{i}.{k}.b'] = t(arrays[f'{b}{k}.bias'])
        for k, ln in (('ln1', 'self_attn_layer_norm'),
                      ('ln2', 'final_layer_norm')):
            p[f'{i}.{k}.w'] = t(arrays[f'{b}{ln}.weight'])
            p[f'{i}.{k}.b'] = t(arrays[f'{b}{ln}.bias'])
    return p


def patch_embed(p: dict, windows: torch.Tensor, cfg: BEATsConfig,
                bf16: bool) -> torch.Tensor:
    """(W, bins, tdim) fbank windows (freq x time) -> (W, tokens, C) f32:
    the patches' product (token n = (bins / 16) t + f, a patch read as
    (time, freq)), LayerNorm, the projection."""
    w = windows.shape[0]
    k = cfg.input_patch_size
    tt, ff = cfg.input_tdim // k, cfg.input_fdim // k
    x = windows.transpose(1, 2).reshape(w, tt, k, ff, k)
    patches = operand(x.permute(0, 1, 3, 2, 4).reshape(w * cfg.tokens, k * k),
                      bf16)
    y = product(patches, p['patch'])
    y = F.layer_norm(y, (cfg.embed_dim,), p['ln0.w'], p['ln0.b'],
                     cfg.layer_norm_eps)
    x = linear(operand(y, bf16), p['proj.w'], p['proj.b'])
    return x.view(w, cfg.tokens, cfg.encoder_embed_dim)


def pos_conv(p: dict, x: torch.Tensor, cfg: BEATsConfig, bf16: bool):
    """x = LayerNorm(x + GELU(conv(x) + bias)) on the (W, T, C) f32 stream,
    in place; returns the first block's operand (bf16 under bf16, else x).
    The grouped convolution runs one group at a time, each a 1 x K conv2d
    of the group's channels read channels-last, (W, C / groups, 1, T): on
    the H100 cuDNN's grouped call of the same shape took 46 ms a 128-window
    block at ~6.5 TFLOP/s, its 16 group calls 3.5 ms. Under bf16 the output
    is bf16, on the card cuDNN's and on the CPU the f32 convolution of the
    same operands rounded once."""
    w, t, c = x.shape
    width = c // cfg.conv_pos_groups
    src = operand(x, bf16)
    y = torch.empty_like(src)
    for g, weight in enumerate(p['pos.w']):
        cols = slice(g * width, (g + 1) * width)
        part = src[..., cols].contiguous().unsqueeze(1).permute(0, 3, 1, 2)
        if bf16 and x.device.type != 'cuda':
            part, weight = part.float(), weight.float()
        out = F.conv2d(part, weight, padding=(0, cfg.conv_pos // 2))
        y[..., cols] = out[:, :, 0, :t].transpose(1, 2)
    x.add_(F.gelu(y.float() + p['pos.b']))
    x.copy_(F.layer_norm(x, (c,), p['ln.w'], p['ln.b'], cfg.layer_norm_eps))
    return operand(x, bf16)


def block(p: dict, i: int, x: torch.Tensor, h: torch.Tensor,
          cfg: BEATsConfig, bf16: bool) -> torch.Tensor:
    """Block ``i`` on the (W, T, C) f32 stream ``x``, in place, from its
    operand ``h`` (x itself under f32, its bf16 copy under bf16); returns
    the next block's operand."""
    w, t, c = x.shape
    rows = x.view(w * t, c)
    y = product(h.view(w * t, c), p[f'{i}.qkv.w'])
    qkv = (epilogue.apply('bias_bf16', y, p[f'{i}.qkv.b']) if bf16
           else y.add_(p[f'{i}.qkv.b'])).view(w, t, 3 * c)
    with span('buzzdetect.attention'):
        a = attention_lib.attention_relpos(
            qkv, cfg.encoder_attention_heads, p['rel'], p[f'{i}.gate'])
    y = product(a.view(w * t, c), p[f'{i}.out.w'])
    with span('buzzdetect.post_ln'):
        h = epilogue.post_ln(y, p[f'{i}.out.b'], rows, p[f'{i}.ln1.w'],
                             p[f'{i}.ln1.b'], cfg.alpha, cfg.layer_norm_eps,
                             bf16)
    y = product(rows if h is None else h, p[f'{i}.fc1.w'])
    f = (epilogue.apply('bias_gelu_bf16', y, p[f'{i}.fc1.b']) if bf16
         else F.gelu(y.add_(p[f'{i}.fc1.b'])))
    y = product(f, p[f'{i}.fc2.w'])
    with span('buzzdetect.post_ln'):
        h = epilogue.post_ln(y, p[f'{i}.fc2.b'], rows, p[f'{i}.ln2.w'],
                             p[f'{i}.ln2.b'], cfg.alpha, cfg.layer_norm_eps,
                             bf16)
    return x if h is None else h


def encoder(p: dict, x: torch.Tensor, h: torch.Tensor, cfg: BEATsConfig,
            bf16: bool) -> torch.Tensor:
    """The blocks on the stream ``x`` (in place) from its operand ``h``."""
    for i in range(cfg.encoder_layers):
        h = block(p, i, x, h, cfg, bf16)
    return x


def head(p: dict, x: torch.Tensor, bf16: bool) -> torch.Tensor:
    """(W, T, C) encoder output -> (W, classes) logits: ``predictor`` of the
    tokens' mean."""
    return linear(operand(x.mean(dim=1), bf16), p['head.w'], p['head.b'])


class BEATsClassifier(FbankWindowClassifier):
    """BEATs over variable-length chunks (``FbankWindowClassifier``: the
    shared wire, dispatch and windows). ``arrays`` are the parameters under
    ``param_shapes``' names. On CUDA the log-mel, attention and epilogue
    libraries are built and loaded here."""

    name = 'BEATs'
    libraries = ('logmel', 'attention', 'epilogue')

    def __init__(self, arrays: dict, cfg: BEATsConfig = BEATsConfig(),
                 framehop_prop: float = 1.0, compute_dtype=None,
                 device='cuda', transfer_dtype='int16'):
        check_params(arrays, cfg)
        if torch.device(device).type == 'cuda' and (
                cfg.head_dim != attention_lib.HEAD_DIM
                or cfg.encoder_embed_dim % 128):
            raise ValueError(f'the card\'s kernels take heads of '
                             f'{attention_lib.HEAD_DIM} and a width that is '
                             f'a multiple of 128, not {cfg.head_dim} and '
                             f'{cfg.encoder_embed_dim}')
        self._init_windows(cfg, dataclasses.replace(
            logmel.BEATS_FBANK, mel_bands=cfg.input_fdim), framehop_prop,
            compute_dtype, device, transfer_dtype)
        self.params = pack_params(arrays, cfg, self.device, self.bf16)

    def _block_scores(self, windows: torch.Tensor) -> torch.Tensor:
        """(W, 128, tdim) windows -> (W, classes) logits."""
        cfg = self.cfg
        with span('buzzdetect.patch_embed'):
            x = patch_embed(self.params, windows, cfg, self.bf16)
        with span('buzzdetect.pos_conv'):
            h = pos_conv(self.params, x, cfg, self.bf16)
        with span('buzzdetect.embed'):
            x = encoder(self.params, x, h, cfg, self.bf16)
        with span('buzzdetect.head'):
            return head(self.params, x, self.bf16)
