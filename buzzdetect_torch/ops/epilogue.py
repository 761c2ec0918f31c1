"""The epilogues of the Audio Spectrogram Transformer's products: CUDA
kernel, plain version, wrappers.

A product's f32 output ``y`` (``(rows, cols)``, cols a multiple of 4) and
its f32 bias become, in one pass:

* ``apply('bias_bf16', y, bias)``: bf16(y + bias), attention's operands
  (qkv);
* ``apply('bias_gelu_bf16', y, bias)``: bf16(gelu(y + bias)), exact (erf)
  GELU in f32, the next product's operand (fc1);
* ``apply('bias_residual', y, bias, x)``: x += y + bias in f32, in place on
  the residual stream (proj, fc2).

On CUDA tensors ``apply`` calls the ``buzzdetect::bias_epilogue`` or
``buzzdetect::bias_residual`` custom operator (``ops/library.py``), which
launches ``csrc/epilogue.cu`` once and counts it in ``apply.launches``; on
CPU tensors the plain version, the same f32 arithmetic in PyTorch. There
is no other path.
"""

import ctypes
from functools import lru_cache

import torch
import torch.nn.functional as F

from buzzdetect_torch.ops.sepconv import _route, device_scope

# the kernel's modes
MODES = ('bias_bf16', 'bias_gelu_bf16', 'bias_residual')


def plain(mode: str, y: torch.Tensor, bias: torch.Tensor, x=None):
    """The plain version of ``mode``; mode 'bias_residual' updates ``x``."""
    s = y + bias
    if mode == 'bias_residual':
        return x.add_(s)
    if mode == 'bias_gelu_bf16':
        s = F.gelu(s)
    return s.to(torch.bfloat16)


@lru_cache(maxsize=None)
def load_kernels():
    """Build (once) and load ``csrc/epilogue.cu``; returns the ctypes
    library."""
    from buzzdetect_torch.ops import _build
    lib = _build.load('epilogue')
    ptr = ctypes.c_void_p
    lib.bz_epilogue.argtypes = [ctypes.c_int, ptr, ptr, ptr,
                                ctypes.c_longlong, ctypes.c_int, ptr]
    lib.bz_epilogue.restype = ctypes.c_int
    lib.bz_epilogue_error_string.argtypes = [ctypes.c_int]
    lib.bz_epilogue_error_string.restype = ctypes.c_char_p
    return lib


def _check(y, bias, out):
    rows, cols = y.shape
    for name, t, dtype in (('y', y, torch.float32),
                           ('bias', bias, torch.float32)):
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f'{name}: expected a contiguous {dtype} tensor, '
                             f'got {t.dtype}')
    if bias.shape != (cols,) or cols % 4 or out.shape != y.shape \
            or not out.is_contiguous():
        raise ValueError(f'epilogue: y {tuple(y.shape)}, bias '
                         f'{tuple(bias.shape)}, out {tuple(out.shape)}')


def _launch(mode: str, y: torch.Tensor, bias: torch.Tensor,
            out: torch.Tensor):
    """``bz_epilogue`` on CUDA tensors: the implementation of both
    operators."""
    _check(y, bias, out)
    lib = load_kernels()
    with device_scope(y.device):
        code = lib.bz_epilogue(MODES.index(mode), y.data_ptr(),
                               bias.data_ptr(), out.data_ptr(), y.shape[0],
                               y.shape[1],
                               torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f'bz_epilogue failed: CUDA error {code} '
                           f'({lib.bz_epilogue_error_string(code).decode()})')
    return out


def apply(mode: str, y: torch.Tensor, bias: torch.Tensor,
          x: torch.Tensor = None) -> torch.Tensor:
    """Mode ``mode`` of ``MODES`` on the (rows, cols) f32 product output
    ``y`` and its f32 bias: the bf16 operand (modes 'bias_bf16',
    'bias_gelu_bf16'), or ``x`` updated in place ('bias_residual')."""
    if mode not in MODES:
        raise ValueError(f'mode must be one of {MODES}')
    if _route(y) == 'cpu':
        return plain(mode, y, bias, x)
    from buzzdetect_torch.ops import library
    if mode == 'bias_residual':
        library.bias_residual(x, y, bias)
        return x
    return library.bias_epilogue(y, bias, mode)


apply.launches = 0
