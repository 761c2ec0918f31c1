"""The YAMNet separable-conv stack: CUDA kernels, plain versions, wrappers.

Counterpart of ``buzzdetect_tpu/ops/pallas_conv.py``: ``fused_front`` runs
layers 2-7 and ``fused_tail`` layers 8-14 plus global average pooling (or
any sep-layer range without pooling). On a CUDA tensor each wrapper launches
its kernel from ``csrc/sepconv.cu`` (exact f32 FFMA; see the note at the top
of that file) and counts the launch in ``<wrapper>.launches``; on a CPU
tensor it computes the plain PyTorch version. There is no other path.

Parameters are the ``yamnet`` dict from ``models/weights.params_from_numpy``:
per layer, ``layerN/depthwise_conv/kernel`` as (9, C) taps (tap
t = (dy+1)*3 + (dx+1) holds kernel[dy+1, dx+1, 0, :]),
``layerN/pointwise_conv/kernel`` as (C, F) row-major, and their (C,) / (F,)
biases.
"""

import ctypes
import threading
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

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


def tail_specs(start_layer: int = 8, stop_layer: int = None):
    """SepSpecs for LAYER_DEFS[start_layer-1:stop_layer-1] with their input
    spatial sizes (stop_layer is exclusive; None runs to the end)."""
    # here, not at the top: importing the models package imports the
    # classifier, which imports this module
    from buzzdetect_torch.models.yamnet import LAYER_DEFS
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


def exact_f32():
    """Keep float32 convolutions and matrix products out of TF32 on the card:
    cuDNN allows TF32 for convolutions by default, which keeps about three
    decimal digits and breaks the 1e-3 score budget."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


# --- plain versions ------------------------------------------------------------

def _sep_layer_plain(params, x, s: SepSpec):
    """(B, H, W, C) -> (B, Ho, Wo, F): one separable layer in torch ops."""
    ph, pw_ = same_pad(s.h, s.stride), same_pad(s.w, s.stride)
    dw = params[f'{s.name}/depthwise_conv/kernel']          # (9, C)
    xc = F.pad(x.permute(0, 3, 1, 2), (pw_[0], pw_[1], ph[0], ph[1]))
    y = F.conv2d(xc, dw.t().reshape(s.c_in, 1, 3, 3), stride=s.stride,
                 groups=s.c_in)
    y = torch.relu(y + params[f'{s.name}/depthwise_conv/bias'][:, None, None])
    b = y.shape[0]
    flat = y.permute(0, 2, 3, 1).reshape(b * s.h_out * s.w_out, s.c_in)
    z = torch.relu(flat @ params[f'{s.name}/pointwise_conv/kernel']
                   + params[f'{s.name}/pointwise_conv/bias'])
    return z.reshape(b, s.h_out, s.w_out, s.c_out)


def _stack_plain(params, x, specs, gap):
    exact_f32()
    for s in specs:
        x = _sep_layer_plain(params, x, s)
    if gap:
        return x.mean(dim=(1, 2))
    return x.reshape(x.shape[0], -1, x.shape[-1])


def fused_front_plain(params, x, *, start_layer=2, stop_layer=8):
    """Plain version of ``fused_front``: (B, H, W, C) -> (B, Ho*Wo, F)."""
    return _stack_plain(params, x, tail_specs(start_layer, stop_layer), False)


def fused_tail_plain(params, x, *, start_layer=8, stop_layer=None, gap=True):
    """Plain version of ``fused_tail``: (B, H, W, C) -> (B, F) with ``gap``,
    else (B, Ho*Wo, F)."""
    return _stack_plain(params, x, tail_specs(start_layer, stop_layer), gap)


# --- kernel launch ---------------------------------------------------------------

@lru_cache(maxsize=None)
def load_kernels():
    """Build (once) and load ``csrc/sepconv.cu``; returns the ctypes library.
    Every pointer and the stream pass as c_void_p: an untyped int argument
    would be cut to 32 bits."""
    from buzzdetect_torch.ops import _build
    lib = _build.load('sepconv')
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bz_sep_stack.argtypes = [ptr, ptr, ptr, ptr, i32, i32, ptr, ptr, i32,
                                 ptr]
    lib.bz_sep_stack.restype = i32
    lib.bz_error_string.argtypes = [i32]
    lib.bz_error_string.restype = ctypes.c_char_p
    return lib


def _check(params, x, specs):
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
    for s in specs:
        for key, shape in ((f'{s.name}/depthwise_conv/kernel', (9, s.c_in)),
                           (f'{s.name}/depthwise_conv/bias', (s.c_in,)),
                           (f'{s.name}/pointwise_conv/kernel',
                            (s.c_in, s.c_out)),
                           (f'{s.name}/pointwise_conv/bias', (s.c_out,))):
            t = params[key]
            if tuple(t.shape) != shape or t.dtype != torch.float32:
                raise ValueError(f'{key}: expected float32 {shape}, got '
                                 f'{t.dtype} {tuple(t.shape)}')
            if t.device != x.device:
                raise ValueError(f'{key} is on {t.device}, input on '
                                 f'{x.device}')


def _launch(params, x, specs, gap):
    """Launch ``bz_sep_stack`` of ``csrc/sepconv.cu`` on the current
    stream; returns the output tensor. Raises on any CUDA error code."""
    if not x.is_contiguous():
        raise ValueError('input must be contiguous NHWC')
    for s in specs:
        for part in ('depthwise_conv', 'pointwise_conv'):
            for leaf in ('kernel', 'bias'):
                if not params[f'{s.name}/{part}/{leaf}'].is_contiguous():
                    raise ValueError(f'{s.name}/{part}/{leaf} must be '
                                     f'contiguous')
    lib = load_kernels()
    b, sl = x.shape[0], specs[-1]
    ptrs = np.array([params[f'{s.name}/{k}'].data_ptr() for s in specs
                     for k in ('depthwise_conv/kernel', 'depthwise_conv/bias',
                               'pointwise_conv/kernel', 'pointwise_conv/bias')],
                    np.int64)
    dims = np.array([[s.h, s.w, s.c_in, s.c_out, s.stride, s.h_out, s.w_out,
                      1 - same_pad(s.h, s.stride)[0],
                      1 - same_pad(s.w, s.stride)[0]] for s in specs],
                    np.int32)
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
    stream = torch.cuda.current_stream(x.device).cuda_stream
    # the C side sizes its grids from the current device's SM count
    with torch.cuda.device(x.device):
        code = lib.bz_sep_stack(x.data_ptr(), out.data_ptr(), buf0.data_ptr(),
                                buf1.data_ptr(), b, len(specs),
                                ptrs.ctypes.data, dims.ctypes.data, int(gap),
                                stream)
    if code != 0:
        raise RuntimeError(f'bz_sep_stack failed: CUDA error {code} '
                           f'({lib.bz_error_string(code).decode()})')
    return out


def _count_launch(wrapper):
    """One more launch on ``wrapper.launches``; inferer threads share the
    wrappers, and ``+=`` on an attribute is not atomic."""
    with _count_lock:
        wrapper.launches += 1


def _route(x):
    """'cpu' -> plain version; 'cuda' -> kernel. Anything else raises."""
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {x.device}')
    return x.device.type


def fused_front(params, x, *, start_layer: int = 2, stop_layer: int = 8):
    """Layer-1 output (B, 48, 32, 32) NHWC -> (B, 6*4, 512) entering layer 8
    (flattened spatial, as the TPU kernel returns it)."""
    specs = tail_specs(start_layer, stop_layer)
    _check(params, x, specs)
    if _route(x) == 'cpu':
        return fused_front_plain(params, x, start_layer=start_layer,
                                 stop_layer=stop_layer)
    out = _launch(params, x, specs, gap=False)
    _count_launch(fused_front)
    return out


def fused_tail(params, x, *, start_layer: int = 8, stop_layer: int = None,
               gap: bool = True):
    """(B, H, W, C) entering ``start_layer`` -> (B, 1024) embeddings with
    ``gap``, else the last layer's activations (B, Ho*Wo, F)."""
    specs = tail_specs(start_layer, stop_layer)
    _check(params, x, specs)
    if _route(x) == 'cpu':
        return fused_tail_plain(params, x, start_layer=start_layer,
                                stop_layer=stop_layer, gap=gap)
    out = _launch(params, x, specs, gap=gap)
    _count_launch(fused_tail)
    return out


_count_lock = threading.Lock()
fused_front.launches = 0
fused_tail.launches = 0
