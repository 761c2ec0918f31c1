"""The YAMNet separable-conv stack: CUDA kernels, plain versions, wrappers.

Counterpart of ``buzzdetect_tpu/ops/pallas_conv.py``: ``fused_front`` runs
layers 2-7 and ``fused_tail`` layers 8-14 plus global average pooling (or
any sep-layer range without pooling). On a CUDA tensor each wrapper calls
its custom operator (``buzzdetect::fused_front`` / ``fused_tail``,
``ops/library.py``), which launches the kernels of ``csrc/sepconv.cu`` (see
the note at the top of that file) and counts the launch in
``<wrapper>.launches[mode]`` (and per layer range in
``<wrapper>.ranges[(start, stop, mode)]``, per range and batch in
``<wrapper>.batches[(start, stop, mode, B)]``); on a CPU tensor it computes the
plain PyTorch version. There is no other path. The pointwise
product runs on FFMA in exact f32 ('highest') and on the tensor cores
('bf16', 'high'; ``layer_route``).

``mode`` selects the pointwise product's operands, as the TPU kernel's
``compute_dtype`` and ``precision`` do (``resolve_mode``):

* ``'highest'``: f32 operands, exact f32 (the TPU's HIGHEST);
* ``'bf16'``: activation and weight rounded to bf16, f32 accumulate (the
  TPU's bf16 ``compute_dtype`` at DEFAULT precision);
* ``'high'``: the emulated HIGH of ``pallas_conv._pw_dot``: activation and
  weight split into bf16 hi and lo halves, ``a_hi*w_hi + a_hi*w_lo +
  a_lo*w_hi`` with f32 accumulate.

The depthwise taps, biases, ReLU and pooling stay f32 in every mode. A
product of two bf16 values is exact in f32, so the plain versions' f32
products of bf16-rounded values compute what the TPU's one-pass bf16
products compute.

Parameters are the ``yamnet`` dict from ``models/weights.params_from_numpy``:
per layer, ``layerN/depthwise_conv/kernel`` as (9, C) taps (tap
t = (dy+1)*3 + (dx+1) holds kernel[dy+1, dx+1, 0, :]),
``layerN/pointwise_conv/kernel`` as (C, F) row-major, and their (C,) / (F,)
biases. ``pack_params`` adds each mode's pointwise operand beside them
(``layerN/pointwise_conv/kernel[bf16]``: (C, F) bf16;
``...[high]``: (2, C, F) bf16 hi, lo), so a caller packs once, not per call.
"""

import collections
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from buzzdetect_torch.ops.common import (
    I32, PTR, Library, exact_f32, resolve_compute_dtype, round_bf16, route)

# YAMNet's layers, (kind, stride, output_filters); every kernel is 3x3
LAYER_DEFS = (
    ('conv', 2, 32),
    ('sep', 1, 64),
    ('sep', 2, 128),
    ('sep', 1, 128),
    ('sep', 2, 256),
    ('sep', 1, 256),
    ('sep', 2, 512),
    ('sep', 1, 512),
    ('sep', 1, 512),
    ('sep', 1, 512),
    ('sep', 1, 512),
    ('sep', 1, 512),
    ('sep', 2, 1024),
    ('sep', 1, 1024),
)


@dataclass(frozen=True)
class SepSpec:
    """One depthwise-separable layer of the stack."""
    index: int            # 1-based layer number in LAYER_DEFS
    h: int                # input spatial height
    w: int                # input spatial width
    c_in: int
    c_out: int
    stride: int

    @property
    def name(self):
        return f'layer{self.index}'

    @property
    def h_out(self):
        return -(-self.h // self.stride)

    @property
    def w_out(self):
        return -(-self.w // self.stride)


@lru_cache(maxsize=None)
def tail_specs(start_layer: int = 8, stop_layer: int = None):
    """SepSpecs for LAYER_DEFS[start_layer-1:stop_layer-1] with their input
    spatial sizes (stop_layer is exclusive; None runs to the end); cached,
    since every launch asks for its range."""
    stop = len(LAYER_DEFS) + 1 if stop_layer is None else stop_layer
    h, w, c = 96, 64, 1
    specs = []
    for i, (kind, stride, filters) in enumerate(LAYER_DEFS, start=1):
        if start_layer <= i < stop:
            if kind != 'sep':
                raise ValueError(f'layer {i} is not a sep layer')
            specs.append(SepSpec(i, h, w, c, filters, stride))
        h, w, c = -(-h // stride), -(-w // stride), filters
    if not specs:
        raise ValueError(f'empty layer range [{start_layer}, {stop})')
    return tuple(specs)


def same_pad(n: int, stride: int, k: int = 3):
    """TF-SAME (before, after) padding of one axis of length ``n``. At stride
    2 on even ``n`` this is (0, 1): bottom/right only, so output i is centred
    on input stride*i + 1. A symmetric pad of 1 would shift the grid."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


MODES = ('highest', 'bf16', 'high')
# the kernel's mode argument (csrc/sepconv.cu, enum Mode)
_MODE_CODE = {'highest': 0, 'bf16': 1, 'high': 2}


def layer_route(mode: str) -> str:
    """The unit that runs a layer's pointwise product in ``mode``: 'ffma'
    (sep_layer_kernel, exact f32) or 'mma' (sep_layer_mma_kernel, bf16
    operands on the tensor cores)."""
    check_mode(mode)
    return 'ffma' if mode == 'highest' else 'mma'


def _kernel_takes(s, mode) -> bool:
    """Whether layer ``s``'s shape fits its route's tiles in csrc/sepconv.cu:
    C in chunks of 16 (FFMA) or 32 (the tensor cores), and F = 64, 128 or a
    multiple of 256 (a block's BN = min(F, 256) channels). The same rule as
    ``takes`` in that file: a change to one is made in the other."""
    chunk = 16 if layer_route(mode) == 'ffma' else 32
    return s.c_in % chunk == 0 and (s.c_out in (64, 128)
                                    or s.c_out % 256 == 0)


# The exact-f32 route's tiles, as csrc/sepconv.cu sizes them: threads per
# block, K chunk, ring stages and position-major A row (16 channels, 4
# floats of padding) of the wide tile (sep_layer_kernel), depthwise rows
# ahead of a stage's input window, the narrow tile's K chunk and row
# (sep_narrow_kernel), and ffma_cost's weight of one float brought in
_FT, _FK, _FRING, _ALD, _XHEAD = 256, 16, 3, 20, 10
_NK, _NLD, _LOAD_COST = 64, 68, 16
# the wide tile's fixed work a block, in positions (``BLOCK_ROWS``)
_BLOCK_ROWS = 48
# what an H100 SXM sizes the grids by: SMs, shared memory per SM and per
# block (opted in), bytes
H100_CARD = (132, 233472, 232448)


@dataclass(frozen=True)
class Geometry:
    """One exact-f32 layer launch: the kernel ('wide': sep_layer_kernel,
    BN = min(F, 256); 'narrow': sep_narrow_kernel), its tile (BN output
    channels x BM positions, TM positions a thread), its grid (blocks along
    M, along N), its cp.async ring stages and dynamic shared memory."""
    kernel: str
    bn: int
    tm: int
    bm: int
    grid: tuple
    ring: int
    smem: int

    @property
    def blocks(self):
        return self.grid[0] * self.grid[1]


def _window_rows(bm, s):
    """``window_rows`` of csrc/sepconv.cu: the input rows the depthwise of
    ``bm`` consecutive outputs of layer ``s`` can read."""
    return (s.stride * (-(-bm // s.w_out) + 1) + 3) * s.w + 2


def _ffma_cost(blocks, rows, rows_in, bn, s, sms):
    """``ffma_cost``: the busiest SM's ceil(blocks / SMs) blocks, each
    ``rows`` x (BN + 9) multiply-adds per input channel (pointwise and
    recomputed depthwise) and BN weights plus the window of ``rows_in``
    positions brought in at ``_LOAD_COST`` a float."""
    return -(-blocks // sms) * (rows * (bn + 9) + _LOAD_COST * (
        bn + _window_rows(rows_in, s)))


def _wide_geometry(s, m, sms, sm_smem, tm=0):
    bn = min(s.c_out, 256)
    ty, grid_n = _FT // (bn // 8), s.c_out // bn

    def price(t):
        return -(-(-(-m // (t * ty)) * grid_n) // sms) * (t * ty
                                                          + _BLOCK_ROWS)
    tm = tm or (4 if price(4) < price(5) else 5)
    bm = tm * ty
    ring = (_FRING if 2 * (_wide_smem(s, bm, bn, _FRING) + 1024) <= sm_smem
            else 2)
    return Geometry('wide', bn, tm, bm, (-(-m // bm), grid_n), ring,
                    _wide_smem(s, bm, bn, ring))


def _wide_smem(s, bm, bn, stages):
    """``ffma_smem``: the wide tile's two A tiles (BM, ``_ALD``) and its
    ring's stages, each a chunk's (16, BN) weights and the next chunk's
    taps, bias and input window, in bytes."""
    stage = _FK * bn + (_XHEAD + _ffma_window_rows(bm, s)) * _FK
    return 4 * (2 * bm * _ALD + stages * stage)


def _ffma_window_rows(bm, s):
    """``ffma_window_rows``: the input rows the wide tile's depthwise of
    ``bm`` consecutive outputs of layer ``s`` can read, at most."""
    return (s.stride * ((bm + s.w_out - 2) // s.w_out) + 3) * s.w + 2


def _narrow_geometry(s, m, bn, tm, block_smem):
    bm, chunks = _FT // bn * tm, s.c_in // _NK

    def smem(stages):
        stage = bn * _NLD + (_XHEAD + _window_rows(bm, s)) * _NK
        return 4 * (bm * _NLD + min(chunks, stages) * stage)
    ring = _FRING if smem(_FRING) <= block_smem else 2
    if s.c_in % _NK or smem(ring) > block_smem:
        ring = 0
    return Geometry('narrow', bn, tm, bm, (-(-m // bm), s.c_out // bn), ring,
                    smem(ring))


def ffma_geometry(s, batch, card=H100_CARD) -> Geometry:
    """The launch of exact-f32 layer ``s`` at ``batch`` on a card of
    ``card`` = (SMs, shared memory per SM, per block), as ``ffma_geometry``
    in csrc/sepconv.cu picks it (a change to one is made in the other): the
    wide tile, unless a narrow one (BN = 8, 16, 32, 64 x TM = 1, 2, 4, the
    first of least cost) costs the busiest SM less (``_ffma_cost``). The
    shapes alone decide: no knob."""
    sms, sm_smem, block_smem = card
    m = batch * s.h_out * s.w_out
    g = _wide_geometry(s, m, sms, sm_smem)
    best = _ffma_cost(g.blocks, g.bm, min(g.bm, m), g.bn, s, sms)
    for bn in (8, 16, 32, 64):
        for tm in (1, 2, 4):
            n = _narrow_geometry(s, m, bn, tm, block_smem)
            if not n.ring:
                continue
            rows = min(n.bm, m)
            cost = _ffma_cost(n.blocks, rows, rows, bn, s, sms)
            if cost < best:
                best, g = cost, n
    return g


def resolve_mode(compute_dtype=torch.float32, precision=None) -> str:
    """The kernel mode for a compute dtype and a product precision
    ('highest' | 'high' | 'default' | None), as ``pallas_conv.
    _resolve_precision`` and ``_pw_dot`` resolve them: None means HIGHEST
    for f32 operands and DEFAULT for bf16; 'high' is the hi/lo split at
    either dtype; bf16 operands at 'default' or 'highest' are one bf16
    product. f32 operands at 'default' (one bf16 pass of f32 operands) are
    not a mode of the product and raise."""
    dtype = resolve_compute_dtype(compute_dtype)
    if precision not in (None, 'highest', 'high', 'default'):
        raise ValueError(f"precision must be 'highest', 'high', 'default' "
                         f"or None, got {precision!r}")
    if precision == 'high':
        return 'high'
    if dtype == torch.bfloat16:
        return 'bf16'
    if precision == 'default':
        raise ValueError("float32 operands at precision 'default' are not a "
                         "mode of the conv kernels; use 'highest' or 'high'")
    return 'highest'


def check_mode(mode):
    if mode not in MODES:
        raise ValueError(f'mode must be one of {MODES}, got {mode!r}')


def pack_pointwise(pw: torch.Tensor, mode: str) -> torch.Tensor:
    """A (C, F) f32 pointwise kernel as ``mode``'s operand, as
    ``pallas_conv._pack_pw`` packs it: itself ('highest'); rounded to bf16
    ('bf16'); or the (2, C, F) bf16 hi/lo split of ``_split_hi_lo``,
    ``w ~= hi + lo`` ('high')."""
    check_mode(mode)
    if mode == 'highest':
        return pw
    hi = pw.to(torch.bfloat16)
    if mode == 'bf16':
        return hi
    lo = (pw - hi.to(torch.float32)).to(torch.bfloat16)
    return torch.stack([hi, lo]).contiguous()


def _packed_key(s, mode):
    key = f'{s.name}/pointwise_conv/kernel'
    return key if mode == 'highest' else f'{key}[{mode}]'


def pack_params(params: dict, mode: str) -> dict:
    """``params`` plus every sep layer's pointwise operand for ``mode``
    (a new dict; the f32 tensors are shared, not copied)."""
    out = dict(params)
    for s in tail_specs(2, None):
        key = _packed_key(s, mode)
        if key not in out:
            out[key] = pack_pointwise(params[f'{s.name}/pointwise_conv/kernel'],
                                      mode)
    return out


def _pointwise(params, s, mode):
    """Layer ``s``'s pointwise operand for ``mode``, as ``pack_params``
    put it beside the f32 params."""
    key = _packed_key(s, mode)
    if key not in params:
        raise KeyError(f'{key}: no {mode} operand; apply '
                       f'sepconv.pack_params(params, {mode!r}) first')
    return params[key]


# --- plain versions ------------------------------------------------------------

def pointwise_plain(flat, pw, mode):
    """The pointwise product of ``mode`` in f32 matrix products (TF32 off):
    the bf16 operands are bf16 values held in f32, whose products are exact,
    and the HIGH split sums its three products as ``_pw_dot`` does."""
    if mode == 'highest':
        return flat @ pw
    if mode == 'bf16':
        return round_bf16(flat) @ pw.to(torch.float32)
    a_hi = round_bf16(flat)
    a_lo = round_bf16(flat - a_hi)
    w_hi, w_lo = pw[0].to(torch.float32), pw[1].to(torch.float32)
    return a_hi @ w_hi + a_hi @ w_lo + a_lo @ w_hi


def _sep_layer_plain(params, x, s: SepSpec, mode='highest'):
    """(B, H, W, C) -> (B, Ho, Wo, F): one separable layer in torch ops."""
    ph, pw_ = same_pad(s.h, s.stride), same_pad(s.w, s.stride)
    dw = params[f'{s.name}/depthwise_conv/kernel']          # (9, C)
    xc = F.pad(x.permute(0, 3, 1, 2), (pw_[0], pw_[1], ph[0], ph[1]))
    y = F.conv2d(xc, dw.t().reshape(s.c_in, 1, 3, 3), stride=s.stride,
                 groups=s.c_in)
    y = torch.relu(y + params[f'{s.name}/depthwise_conv/bias'][:, None, None])
    b = y.shape[0]
    flat = y.permute(0, 2, 3, 1).reshape(b * s.h_out * s.w_out, s.c_in)
    z = torch.relu(pointwise_plain(flat, _pointwise(params, s, mode), mode)
                   + params[f'{s.name}/pointwise_conv/bias'])
    return z.reshape(b, s.h_out, s.w_out, s.c_out)


def _stack_plain(params, x, specs, gap, mode):
    check_mode(mode)
    exact_f32()
    for s in specs:
        x = _sep_layer_plain(params, x, s, mode)
    if gap:
        return x.mean(dim=(1, 2))
    return x.reshape(x.shape[0], -1, x.shape[-1])


def fused_front_plain(params, x, *, start_layer=2, stop_layer=8,
                      mode='highest'):
    """Plain version of ``fused_front``: (B, H, W, C) -> (B, Ho*Wo, F)."""
    return _stack_plain(params, x, tail_specs(start_layer, stop_layer), False,
                        mode)


def fused_tail_plain(params, x, *, start_layer=8, stop_layer=None, gap=True,
                     mode='highest'):
    """Plain version of ``fused_tail``: (B, H, W, C) -> (B, F) with ``gap``,
    else (B, Ho*Wo, F)."""
    return _stack_plain(params, x, tail_specs(start_layer, stop_layer), gap,
                        mode)


# --- kernel launch ---------------------------------------------------------------

# the C interface of csrc/sepconv.cu
LIBRARY = Library('sepconv', {
    'bz_sep_stack': (I32, [PTR] * 4 + [I32, I32, PTR, PTR, I32, I32, PTR]),
    'bz_sep_geometry': (I32, [I32, I32, PTR, I32, I32, I32, PTR]),
    'bz_sep_layer_at': (I32, [PTR, PTR, I32, PTR, PTR, I32, I32, I32, PTR]),
    'bz_sep_card': (I32, [PTR]),
}, errors='bz_error_string')
load_kernels, bind = LIBRARY.load, LIBRARY.bind


def _layer_dims(specs):
    """The layers' host descriptors for ``bz_sep_stack``: (h, w, C, F,
    stride, Ho, Wo, and each axis's centre offset, 1 - pad_before)."""
    return np.array([[s.h, s.w, s.c_in, s.c_out, s.stride, s.h_out, s.w_out,
                      1 - same_pad(s.h, s.stride)[0],
                      1 - same_pad(s.w, s.stride)[0]] for s in specs],
                    np.int32)


def library_card(lib=None):
    """(SMs, shared memory per SM, per block) of the current CUDA device, as
    the library sizes its grids by them (``bz_sep_card``)."""
    lib = lib or load_kernels()
    out = np.zeros(3, np.int32)
    LIBRARY.check(lib, 'bz_sep_card', lib.bz_sep_card(out.ctypes.data))
    return tuple(int(v) for v in out)


def library_geometry(specs, batch, card, lib=None):
    """The library's own choice for each exact-f32 layer of ``specs`` at
    ``batch`` on ``card`` (``bz_sep_geometry``, a host function), as
    Geometry; ``ffma_geometry`` is its mirror."""
    lib = lib or load_kernels()
    out = np.zeros((len(specs), 8), np.int32)
    dims = _layer_dims(specs)
    LIBRARY.check(lib, 'bz_sep_geometry', lib.bz_sep_geometry(
        batch, len(specs), dims.ctypes.data, *card, out.ctypes.data))
    return [Geometry('narrow' if g[0] else 'wide', *map(int, g[1:4]),
                     (int(g[4]), int(g[5])), int(g[6]), int(g[7]))
            for g in out]


def _check(params, x, specs, mode):
    """Validate the input and every layer's shape and operands for ``mode``;
    returns the per-layer (dw, dw_b, pw, pw_b) tensors the kernel reads,
    with the pointwise kernel as ``mode``'s operand."""
    for s in specs:
        if not _kernel_takes(s, mode):
            raise ValueError(f'{s.name}: the {layer_route(mode)} kernel does '
                             f'not take C={s.c_in}, F={s.c_out} in mode '
                             f'{mode!r}')
    s0 = specs[0]
    want = (s0.h, s0.w, s0.c_in)
    if x.dim() != 4 or tuple(x.shape[1:]) != want:
        raise ValueError(f'expected (B, {want[0]}, {want[1]}, {want[2]}) '
                         f'NHWC input for layer {s0.index}, got '
                         f'{tuple(x.shape)}')
    if x.dtype != torch.float32:
        raise TypeError(f'expected float32 activations, got {x.dtype}')
    if x.shape[0] == 0:
        raise ValueError('empty batch')
    pw_dtype = torch.float32 if mode == 'highest' else torch.bfloat16
    operands = []
    for s in specs:
        pw_shape = (s.c_in, s.c_out) if mode != 'high' else (2, s.c_in,
                                                             s.c_out)
        layer = ((f'{s.name}/depthwise_conv/kernel', (9, s.c_in),
                  torch.float32, params[f'{s.name}/depthwise_conv/kernel']),
                 (f'{s.name}/depthwise_conv/bias', (s.c_in,), torch.float32,
                  params[f'{s.name}/depthwise_conv/bias']),
                 (_packed_key(s, mode), pw_shape, pw_dtype,
                  _pointwise(params, s, mode)),
                 (f'{s.name}/pointwise_conv/bias', (s.c_out,), torch.float32,
                  params[f'{s.name}/pointwise_conv/bias']))
        for key, shape, dtype, t in layer:
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise ValueError(f'{key}: expected {dtype} {shape}, got '
                                 f'{t.dtype} {tuple(t.shape)}')
            if t.device != x.device:
                raise ValueError(f'{key} is on {t.device}, input on '
                                 f'{x.device}')
        operands.append(tuple(t for *_, t in layer))
    return operands


def _launch(operands, x, specs, gap, mode, lib=None):
    """Launch ``bz_sep_stack`` of ``csrc/sepconv.cu`` (or of ``lib``,
    another build of it) on the current stream; returns the output tensor.
    Raises on any CUDA error code."""
    if not x.is_contiguous():
        raise ValueError('input must be contiguous NHWC')
    if not all(t.is_contiguous() for layer in operands for t in layer):
        raise ValueError('every weight and bias must be contiguous')
    lib = lib or load_kernels()
    b, sl = x.shape[0], specs[-1]
    ptrs = np.array([t.data_ptr() for layer in operands for t in layer],
                    np.int64)
    dims = _layer_dims(specs)
    # ping-pong scratch for every layer output that does not go to `out`
    inter = specs if gap else specs[:-1]
    n_scratch = max((b * s.h_out * s.w_out * s.c_out for s in inter),
                    default=1)
    buf0 = torch.empty(n_scratch, dtype=torch.float32, device=x.device)
    buf1 = torch.empty(n_scratch if len(inter) > 1 else 1,
                       dtype=torch.float32, device=x.device)
    out = torch.empty((b, sl.c_out) if gap
                      else (b, sl.h_out * sl.w_out, sl.c_out),
                      dtype=torch.float32, device=x.device)
    # the C side sizes its grids from the current device's SM count
    LIBRARY.launch(lib, 'bz_sep_stack', x.device, x.data_ptr(),
                   out.data_ptr(), buf0.data_ptr(), buf1.data_ptr(), b,
                   len(specs), ptrs.ctypes.data, dims.ctypes.data, int(gap),
                   _MODE_CODE[mode])
    return out


def _flat(operands):
    """``_check``'s per-layer tuples as the one ``Tensor[]`` the custom
    operators take (``ops/library.py``)."""
    return [t for layer in operands for t in layer]


def fused_front(params, x, *, start_layer: int = 2, stop_layer: int = 8,
                mode: str = 'highest'):
    """Layer-1 output (B, 48, 32, 32) NHWC -> (B, 6*4, 512) entering layer 8
    (flattened spatial, as the TPU kernel returns it)."""
    check_mode(mode)
    specs = tail_specs(start_layer, stop_layer)
    operands = _check(params, x, specs, mode)
    if route(x) == 'cpu':
        return fused_front_plain(params, x, start_layer=start_layer,
                                 stop_layer=stop_layer, mode=mode)
    from buzzdetect_torch.ops import library
    return library.fused_front(x, _flat(operands), specs[0].index,
                               specs[-1].index + 1, mode)


def fused_tail(params, x, *, start_layer: int = 8, stop_layer: int = None,
               gap: bool = True, mode: str = 'highest'):
    """(B, H, W, C) entering ``start_layer`` -> (B, 1024) embeddings with
    ``gap``, else the last layer's activations (B, Ho*Wo, F)."""
    check_mode(mode)
    specs = tail_specs(start_layer, stop_layer)
    operands = _check(params, x, specs, mode)
    if route(x) == 'cpu':
        return fused_tail_plain(params, x, start_layer=start_layer,
                                stop_layer=stop_layer, gap=gap, mode=mode)
    from buzzdetect_torch.ops import library
    return library.fused_tail(x, _flat(operands), specs[0].index,
                              specs[-1].index + 1, gap, mode)


fused_front.launches = dict.fromkeys(MODES, 0)
fused_tail.launches = dict.fromkeys(MODES, 0)
fused_front.ranges = collections.Counter()
fused_tail.ranges = collections.Counter()
fused_front.batches = collections.Counter()
fused_tail.batches = collections.Counter()
