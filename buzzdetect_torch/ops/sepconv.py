"""The YAMNet separable-conv stack: CUDA kernels, plain versions, wrappers.

Counterpart of ``buzzdetect_tpu/ops/pallas_conv.py``: ``fused_front`` runs
layers 2-7 and ``fused_tail`` layers 8-14 plus global average pooling (or
any sep-layer range without pooling). On a CUDA tensor each wrapper launches
its kernels from ``csrc/sepconv.cu`` (see the note at the top of that file)
and counts the launch in ``<wrapper>.launches[mode]``; on a CPU tensor it
computes the plain PyTorch version. There is no other path. The pointwise
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

import contextlib
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


MODES = ('highest', 'bf16', 'high')
# the kernel's mode argument (csrc/sepconv.cu, enum Mode)
_MODE_CODE = {'highest': 0, 'bf16': 1, 'high': 2}


def layer_route(mode: str) -> str:
    """The unit that runs a layer's pointwise product in ``mode``: 'ffma'
    (sep_layer_kernel, exact f32) or 'mma' (sep_layer_mma_kernel, bf16
    operands on the tensor cores)."""
    _check_mode(mode)
    return 'ffma' if mode == 'highest' else 'mma'


def _kernel_takes(s, mode) -> bool:
    """Whether layer ``s``'s shape fits its route's tiles in csrc/sepconv.cu:
    C in chunks of 16 (FFMA) or 32 (the tensor cores), and F = 64, 128 or a
    multiple of 256 (a block's BN = min(F, 256) channels). The same rule as
    ``takes`` in that file: a change to one is made in the other."""
    chunk = 16 if layer_route(mode) == 'ffma' else 32
    return s.c_in % chunk == 0 and (s.c_out in (64, 128)
                                    or s.c_out % 256 == 0)


def resolve_compute_dtype(compute_dtype) -> torch.dtype:
    """None, float32 (or 'float32') -> torch.float32; bfloat16 (or
    'bfloat16') -> torch.bfloat16; anything else raises."""
    if compute_dtype in (None, torch.float32, 'float32'):
        return torch.float32
    if compute_dtype in (torch.bfloat16, 'bfloat16'):
        return torch.bfloat16
    raise ValueError(f'compute_dtype must be float32 or bfloat16, got '
                     f'{compute_dtype!r}')


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


def _check_mode(mode):
    if mode not in MODES:
        raise ValueError(f'mode must be one of {MODES}, got {mode!r}')


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest bf16 value (ties to even), kept in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def pack_pointwise(pw: torch.Tensor, mode: str) -> torch.Tensor:
    """A (C, F) f32 pointwise kernel as ``mode``'s operand, as
    ``pallas_conv._pack_pw`` packs it: itself ('highest'); rounded to bf16
    ('bf16'); or the (2, C, F) bf16 hi/lo split of ``_split_hi_lo``,
    ``w ~= hi + lo`` ('high')."""
    _check_mode(mode)
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


def exact_f32():
    """Keep float32 convolutions and matrix products out of TF32 on the card:
    cuDNN allows TF32 for convolutions by default, which keeps about three
    decimal digits and breaks the 1e-3 score budget."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


# --- plain versions ------------------------------------------------------------

def _pointwise_plain(flat, pw, mode):
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
    z = torch.relu(_pointwise_plain(flat, _pointwise(params, s, mode), mode)
                   + params[f'{s.name}/pointwise_conv/bias'])
    return z.reshape(b, s.h_out, s.w_out, s.c_out)


def _stack_plain(params, x, specs, gap, mode):
    _check_mode(mode)
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

@lru_cache(maxsize=None)
def load_kernels():
    """Build (once) and load ``csrc/sepconv.cu``; returns the ctypes library.
    Every pointer and the stream pass as c_void_p: an untyped int argument
    would be cut to 32 bits."""
    from buzzdetect_torch.ops import _build
    return bind(_build.load('sepconv'))


def bind(lib):
    """Declare the C interface of a library built from ``csrc/sepconv.cu``
    on ``lib`` (a ctypes CDLL); returns it."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bz_sep_stack.argtypes = [ptr, ptr, ptr, ptr, i32, i32, ptr, ptr, i32,
                                 i32, ptr]
    lib.bz_sep_stack.restype = i32
    lib.bz_error_string.argtypes = [i32]
    lib.bz_error_string.restype = ctypes.c_char_p
    return lib


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
                                _MODE_CODE[mode], stream)
    if code != 0:
        raise RuntimeError(f'bz_sep_stack failed: CUDA error {code} '
                           f'({lib.bz_error_string(code).decode()})')
    return out


def _count_launch(wrapper, mode=None):
    """One more launch on ``wrapper.launches`` (or on its ``mode`` entry);
    inferer threads share the wrappers, and ``+=`` is not atomic."""
    with _count_lock:
        if mode is None:
            wrapper.launches += 1
        else:
            wrapper.launches[mode] += 1


def _route(x):
    """'cpu' -> plain version; 'cuda' -> kernel. Anything else raises."""
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {x.device}')
    return x.device.type


def device_scope(device):
    """A context that makes CUDA ``device`` current: a no-op where it is
    current already, which spares a launch the switch there and back."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def fused_front(params, x, *, start_layer: int = 2, stop_layer: int = 8,
                mode: str = 'highest'):
    """Layer-1 output (B, 48, 32, 32) NHWC -> (B, 6*4, 512) entering layer 8
    (flattened spatial, as the TPU kernel returns it)."""
    _check_mode(mode)
    specs = tail_specs(start_layer, stop_layer)
    operands = _check(params, x, specs, mode)
    if _route(x) == 'cpu':
        return fused_front_plain(params, x, start_layer=start_layer,
                                 stop_layer=stop_layer, mode=mode)
    out = _launch(operands, x, specs, False, mode)
    _count_launch(fused_front, mode)
    return out


def fused_tail(params, x, *, start_layer: int = 8, stop_layer: int = None,
               gap: bool = True, mode: str = 'highest'):
    """(B, H, W, C) entering ``start_layer`` -> (B, 1024) embeddings with
    ``gap``, else the last layer's activations (B, Ho*Wo, F)."""
    _check_mode(mode)
    specs = tail_specs(start_layer, stop_layer)
    operands = _check(params, x, specs, mode)
    if _route(x) == 'cpu':
        return fused_tail_plain(params, x, start_layer=start_layer,
                                stop_layer=stop_layer, gap=gap, mode=mode)
    out = _launch(operands, x, specs, gap, mode)
    _count_launch(fused_tail, mode)
    return out


_count_lock = threading.Lock()
fused_front.launches = dict.fromkeys(MODES, 0)
fused_tail.launches = dict.fromkeys(MODES, 0)
