"""The Audio Spectrogram Transformer (AST) on the port's chunk path.

Gong, Chung and Glass 2021, "AST: Audio Spectrogram Transformer"
(arXiv:2104.01778, https://github.com/YuanGongND/ast); its AudioSet model
(``audioset_10_10_0.4593``: ``input_tdim`` 1024, ``fstride`` = ``tstride``
= 10, DeiT-base-distilled at 384):

* the wire (int16 / 32768) -> the Kaldi fbank (``ops/logmel.py``,
  ``KaldiFbankConfig``: 128 bins a 10 ms frame, AST's normalisation), once
  a chunk, on the card one launch of the fused log-mel kernel;
* windows of ``input_tdim`` frames (10.24 s), every ``framehop_prop`` of a
  window snapped to whole frames, taken as views of the chunk's fbank and
  read as (128 freq x 1024 time);
* the patch embedding: a 16 x 16 conv at strides (10, 10), 12 x 101 =
  1,212 patches, as one product of the gathered patches; the cls and
  distillation tokens before them, a learned position embedding added;
* 12 pre-LN blocks: ``x += proj(attn(LN1(x)))``, ``x += fc2(GELU(fc1(LN2(
  x))))``; LayerNorm eps 1e-6; qkv 768 -> 2304 with bias, 12 heads of 64,
  scale 1/8, no mask (``ops/attention.py``, one launch a block); MLP 3072,
  exact (erf) GELU;
  the last block's rows after attention only the two tokens' (every row
  after attention is its own token's, so theirs are the same);
* the final LayerNorm of the two tokens, their mean, and ``mlp_head``:
  LayerNorm(eps 1e-5) and a 768 -> 527 product: 527 AudioSet logits a
  window.

Parameters (``param_shapes``) carry the published state-dict's names
without DataParallel's ``module.`` prefix (``v.blocks.3.attn.qkv.weight``,
``mlp_head.1.bias``, ...); ``models/convert.ast_npz_from_state_dict`` maps a
checkpoint to them. Without a checkpoint, ``seeded_params`` makes them from
a seed: every tensor N(0, 0.02^2) from ``np.random.default_rng(
SeedSequence([seed, crc32(name)]))``, LayerNorm weights 1, biases 0.

Precision: ``compute_dtype`` float32 is exact f32 (TF32 off); bfloat16
gives every product (patch embedding, qkv, attention's QK^T and PV, proj,
fc1, fc2, the head) bf16 operands and f32 accumulation, and keeps the
residual stream, LayerNorm statistics, softmax and GELU in f32. On the card
a bf16 product is cuBLAS's with an f32 output (``aten::mm.dtype``), and its
bias with what follows it (the bf16 rounding of qkv; GELU and the rounding
after fc1; the residual add after proj and fc2) one pass of
``ops/epilogue.py``; on the CPU the f32 product of the bf16-rounded
operands and the same f32 arithmetic, the same function.

Spans (``runtime/spans.py``) inside ``buzzdetect.classify``:
``buzzdetect.frontend`` (the fbank), and for each block of up to
``WINDOW_BLOCK`` windows ``buzzdetect.patch_embed``, ``buzzdetect.embed``
(the encoder, with a ``buzzdetect.attention`` around each attention call)
and ``buzzdetect.head``.
"""

import zlib
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from buzzdetect_torch.models.classifier import (WireClassifier,
                                                 _frontend_input,
                                                 resolve_device)
from buzzdetect_torch.ops import _build, attention as attention_lib
from buzzdetect_torch.ops import epilogue, logmel
from buzzdetect_torch.ops.sepconv import exact_f32, resolve_compute_dtype
from buzzdetect_torch.runtime.spans import span

# windows a pass of the encoder takes at most: a chunk's windows go through
# in blocks of this many (memory grows with it; a 128-window block holds
# about 5 GB of activations in bf16)
WINDOW_BLOCK = 128
INIT_STD = 0.02


@dataclass(frozen=True)
class ASTConfig:
    """AST's sizes, under the published argument names where it has them."""
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    label_dim: int = 527
    input_fdim: int = 128
    input_tdim: int = 1024
    patch_size: int = 16
    fstride: int = 10
    tstride: int = 10
    layer_norm_eps: float = 1e-6
    head_layer_norm_eps: float = 1e-5

    @classmethod
    def from_sizes(cls, sizes: dict) -> 'ASTConfig':
        """The configuration of a ``config_model.json``'s ``sizes``; keys it
        does not know are refused."""
        known = set(cls.__dataclass_fields__)
        extra = set(sizes) - known
        if extra:
            raise ValueError(f'unknown AST sizes: {sorted(extra)}')
        return cls(**sizes)

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def f_dim(self) -> int:
        return (self.input_fdim - self.patch_size) // self.fstride + 1

    @property
    def t_dim(self) -> int:
        return (self.input_tdim - self.patch_size) // self.tstride + 1

    @property
    def patches(self) -> int:
        return self.f_dim * self.t_dim

    @property
    def tokens(self) -> int:
        return self.patches + 2


def param_shapes(cfg: ASTConfig) -> dict:
    """{name: shape} of every parameter, in the published order."""
    c, p = cfg.embed_dim, cfg.patch_size
    out = {'v.cls_token': (1, 1, c), 'v.dist_token': (1, 1, c),
           'v.pos_embed': (1, cfg.tokens, c),
           'v.patch_embed.proj.weight': (c, 1, p, p),
           'v.patch_embed.proj.bias': (c,)}
    for i in range(cfg.depth):
        b = f'v.blocks.{i}.'
        out.update({b + 'norm1.weight': (c,), b + 'norm1.bias': (c,),
                    b + 'attn.qkv.weight': (3 * c, c),
                    b + 'attn.qkv.bias': (3 * c,),
                    b + 'attn.proj.weight': (c, c),
                    b + 'attn.proj.bias': (c,),
                    b + 'norm2.weight': (c,), b + 'norm2.bias': (c,),
                    b + 'mlp.fc1.weight': (cfg.mlp_dim, c),
                    b + 'mlp.fc1.bias': (cfg.mlp_dim,),
                    b + 'mlp.fc2.weight': (c, cfg.mlp_dim),
                    b + 'mlp.fc2.bias': (c,)})
    out.update({'v.norm.weight': (c,), 'v.norm.bias': (c,),
                'mlp_head.0.weight': (c,), 'mlp_head.0.bias': (c,),
                'mlp_head.1.weight': (cfg.label_dim, c),
                'mlp_head.1.bias': (cfg.label_dim,)})
    return out


def _layer_norm_weight(name: str) -> bool:
    return name.endswith(('norm1.weight', 'norm2.weight', 'v.norm.weight',
                          'mlp_head.0.weight'))


def seeded_params(cfg: ASTConfig, seed: int) -> dict:
    """Every parameter from ``seed``: N(0, 0.02^2) drawn in float64 from
    ``default_rng(SeedSequence([seed, crc32(name)]))`` and rounded to f32;
    LayerNorm weights 1; biases 0."""
    out = {}
    for name, shape in param_shapes(cfg).items():
        if _layer_norm_weight(name):
            out[name] = np.ones(shape, np.float32)
        elif name.endswith('.bias'):
            out[name] = np.zeros(shape, np.float32)
        else:
            rng = np.random.default_rng(np.random.SeedSequence(
                [int(seed), zlib.crc32(name.encode())]))
            out[name] = (rng.standard_normal(shape) * INIT_STD).astype(
                np.float32)
    return out


def check_params(arrays: dict, cfg: ASTConfig):
    """Raise unless ``arrays`` holds every parameter at its shape."""
    for name, shape in param_shapes(cfg).items():
        if name not in arrays:
            raise ValueError(f'AST parameters: {name} is missing')
        if tuple(arrays[name].shape) != shape:
            raise ValueError(f'AST parameters: {name} is '
                             f'{tuple(arrays[name].shape)}, expected {shape}')


# --- the forward pass ----------------------------------------------------------

PRODUCTS = ('v.patch_embed.proj.weight', 'attn.qkv.weight',
            'attn.proj.weight', 'mlp.fc1.weight', 'mlp.fc2.weight',
            'mlp_head.1.weight')


def pack_params(arrays: dict, cfg: ASTConfig, device,
                bf16: bool) -> dict:
    """The parameters on ``device``: the products' weights as (out, in)
    matrices, in bf16 under bf16 (the operands they are), everything else
    f32."""
    out = {}
    for name in param_shapes(cfg):
        t = torch.from_numpy(np.ascontiguousarray(arrays[name],
                                                  np.float32)).to(device)
        if name.endswith(PRODUCTS):
            t = t.reshape(t.shape[0], -1)
            if bf16:
                t = t.to(torch.bfloat16)
        out[name] = t
    return out


def _operand(x: torch.Tensor, bf16: bool) -> torch.Tensor:
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


def patch_embed(p: dict, windows: torch.Tensor, cfg: ASTConfig,
                bf16: bool) -> torch.Tensor:
    """(W, 128, 1024) windows (freq x time) -> (W, tokens, C): the patches'
    product, the two tokens before them, the position embedding."""
    w = windows.shape[0]
    k, c = cfg.patch_size, cfg.embed_dim
    patches = windows.unfold(1, k, cfg.fstride).unfold(2, k, cfg.tstride)
    patches = _operand(patches.reshape(w * cfg.patches, k * k), bf16)
    x = linear(patches, p['v.patch_embed.proj.weight'],
               p['v.patch_embed.proj.bias']).view(w, cfg.patches, c)
    pos = p['v.pos_embed'][0]
    out = torch.empty((w, cfg.tokens, c), dtype=torch.float32,
                      device=x.device)
    out[:, 0] = p['v.cls_token'][0, 0] + pos[0]
    out[:, 1] = p['v.dist_token'][0, 0] + pos[1]
    torch.add(x, pos[2:], out=out[:, 2:])
    return out


def block(p: dict, i: int, x: torch.Tensor, cfg: ASTConfig, bf16: bool,
          keep: int = None) -> torch.Tensor:
    """Encoder block ``i`` on the (W, T, C) f32 residual stream, in place.
    With ``keep``, the rows after attention are only the first ``keep``
    tokens' (attention still reads every token's keys and values), and
    the (W, keep, C) stream comes back."""
    w, t, c = x.shape
    b = f'v.blocks.{i}.'
    eps = cfg.layer_norm_eps
    h = F.layer_norm(x, (c,), p[b + 'norm1.weight'], p[b + 'norm1.bias'], eps)
    y = product(_operand(h.view(w * t, c), bf16), p[b + 'attn.qkv.weight'])
    # q, k and v are only the operands of attention's two products
    qkv = (epilogue.apply('bias_bf16', y, p[b + 'attn.qkv.bias']) if bf16
           else y.add_(p[b + 'attn.qkv.bias'])).view(w, t, 3 * c)
    with span('buzzdetect.attention'):
        a = attention_lib.attention(qkv, cfg.num_heads)
    if keep is not None:
        x, a, t = x[:, :keep].contiguous(), a[:, :keep].contiguous(), keep
    rows = x.view(w * t, c)
    epilogue.apply('bias_residual', product(a.view(w * t, c),
                                            p[b + 'attn.proj.weight']),
                   p[b + 'attn.proj.bias'], rows)
    h = F.layer_norm(x, (c,), p[b + 'norm2.weight'], p[b + 'norm2.bias'], eps)
    y = product(_operand(h.view(w * t, c), bf16), p[b + 'mlp.fc1.weight'])
    f = (epilogue.apply('bias_gelu_bf16', y, p[b + 'mlp.fc1.bias']) if bf16
         else F.gelu(y.add_(p[b + 'mlp.fc1.bias'])))
    epilogue.apply('bias_residual', product(f, p[b + 'mlp.fc2.weight']),
                   p[b + 'mlp.fc2.bias'], rows)
    return x


def encoder(p: dict, x: torch.Tensor, cfg: ASTConfig,
            bf16: bool) -> torch.Tensor:
    """The blocks; the last keeps only the two tokens the head reads (each
    token's rows after attention are its own, so theirs are the same)."""
    for i in range(cfg.depth):
        x = block(p, i, x, cfg, bf16, keep=2 if i == cfg.depth - 1 else None)
    return x


def head(p: dict, x: torch.Tensor, cfg: ASTConfig,
         bf16: bool) -> torch.Tensor:
    """(W, T >= 2, C) encoder output -> (W, classes) logits: the final
    LayerNorm of the two tokens, their mean, ``mlp_head``."""
    c = cfg.embed_dim
    two = F.layer_norm(x[:, :2], (c,), p['v.norm.weight'], p['v.norm.bias'],
                       cfg.layer_norm_eps)
    pooled = (two[:, 0] + two[:, 1]) / 2
    h = F.layer_norm(pooled, (c,), p['mlp_head.0.weight'],
                     p['mlp_head.0.bias'], cfg.head_layer_norm_eps)
    return linear(_operand(h, bf16), p['mlp_head.1.weight'],
                  p['mlp_head.1.bias'])


def window_hop_frames(cfg: ASTConfig, framehop_prop: float) -> int:
    """The window hop in whole 10 ms frames: ``framehop_prop`` of a window,
    rounded; at least one frame."""
    hop = int(round(cfg.input_tdim * framehop_prop))
    if hop < 1:
        raise ValueError(f'framehop_prop={framehop_prop} is below one 10 ms '
                         f'frame of a {cfg.input_tdim}-frame window')
    return hop


class ASTClassifier(WireClassifier):
    """AST over variable-length chunks, on the shared wire and dispatch
    (``WireClassifier``).

    A chunk of n samples is padded, as YAMNet's patches are, to whole
    windows: one for the first ``input_tdim`` frames (400 + 160 (tdim - 1)
    samples), one for each further window hop or part of one, none that
    would start at or past the chunk's last sample. ``arrays`` are the
    parameters under ``param_shapes``' names. On CUDA the log-mel,
    attention and epilogue libraries are built and loaded here."""

    def __init__(self, arrays: dict, cfg: ASTConfig = ASTConfig(),
                 framehop_prop: float = 1.0, compute_dtype=None,
                 device='cuda', transfer_dtype='int16'):
        self.cfg = cfg
        self.fbank = logmel.KaldiFbankConfig(mel_bands=cfg.input_fdim)
        logmel._check_geometry(self.fbank)
        self.hop_frames = window_hop_frames(cfg, framehop_prop)
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        self.bf16 = self.compute_dtype == torch.bfloat16
        self._init_wire(transfer_dtype)
        self.device = resolve_device(device)
        exact_f32()
        check_params(arrays, cfg)
        if self.device.type == 'cuda':
            if cfg.head_dim != attention_lib.HEAD_DIM:
                raise ValueError(f'the attention kernel takes heads of '
                                 f'{attention_lib.HEAD_DIM}, not '
                                 f'{cfg.head_dim}')
            _build.build_all(['logmel', 'attention', 'epilogue'])
            logmel.load_kernels()
            attention_lib.load_kernels()
            epilogue.load_kernels()
        self.params = pack_params(arrays, cfg, self.device, self.bf16)

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

    def _classify(self, wavs: torch.Tensor,
                  resample_args=None) -> torch.Tensor:
        """(..., L) padded wire waveforms -> (..., windows, classes)."""
        if resample_args is not None:
            raise ValueError('the AST classifier takes 16 kHz chunks; it '
                             'does not resample on the device')
        cfg = self.cfg
        with span('buzzdetect.classify'):
            with span('buzzdetect.frontend'):
                fb = logmel.log_mel_spectrogram_fused(
                    _frontend_input(wavs, 'pallas'), self.fbank)
            lead = fb.shape[:-2]
            # (..., W, 128, tdim): each window a view of the fbank
            windows = fb.unfold(-2, cfg.input_tdim, self.hop_frames)
            windows = windows.reshape(-1, cfg.input_fdim, cfg.input_tdim)
            outs = []
            for lo in range(0, windows.shape[0], WINDOW_BLOCK):
                part = windows[lo:lo + WINDOW_BLOCK]
                with span('buzzdetect.patch_embed'):
                    x = patch_embed(self.params, part, cfg, self.bf16)
                with span('buzzdetect.embed'):
                    x = encoder(self.params, x, cfg, self.bf16)
                with span('buzzdetect.head'):
                    outs.append(head(self.params, x, cfg, self.bf16))
            scores = outs[0] if len(outs) == 1 else torch.cat(outs)
            return scores.reshape(*lead, -1, cfg.label_dim)
