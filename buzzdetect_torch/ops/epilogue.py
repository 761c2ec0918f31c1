"""The epilogues of the transformers' products (the Audio Spectrogram
Transformer's and BEATs'): CUDA kernel, plain version, wrappers.

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

BEATs' deep-norm post-LN (``post_ln``): x = LayerNorm(alpha x + (y +
bias)) in place on the f32 residual stream, and under bf16 the same values
rounded to bf16, the next product's operand, in one pass; on CUDA tensors
the ``buzzdetect::post_ln`` operator, one launch of ``bz_post_ln``,
counted in ``post_ln.launches['post_ln']``; on CPU tensors ``post_ln_plain``.
"""

import torch
import torch.nn.functional as F

from buzzdetect_torch.ops.common import F32, I32, I64, PTR, Library, route

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


def post_ln_plain(y: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
                  weight: torch.Tensor, norm_bias: torch.Tensor,
                  alpha: float, eps: float, bf16: bool):
    """The plain version of ``post_ln``: x = LayerNorm(alpha x + (y + bias))
    in place; the bf16 copy of the new x, or None."""
    v = (x * alpha).add_(y + bias)
    x.copy_(F.layer_norm(v, (x.shape[-1],), weight, norm_bias, eps))
    return x.to(torch.bfloat16) if bf16 else None


# the C interface of csrc/epilogue.cu
LIBRARY = Library('epilogue', {
    'bz_epilogue': (I32, [I32, PTR, PTR, PTR, I64, I32, PTR]),
    'bz_post_ln': (I32, [PTR, PTR, PTR, PTR, PTR, PTR, I64, I32, F32, F32,
                         PTR]),
}, errors='bz_epilogue_error_string')
load_kernels = LIBRARY.load


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
    LIBRARY.launch(load_kernels(), 'bz_epilogue', y.device,
                   MODES.index(mode), y.data_ptr(), bias.data_ptr(),
                   out.data_ptr(), y.shape[0], y.shape[1])
    return out


def apply(mode: str, y: torch.Tensor, bias: torch.Tensor,
          x: torch.Tensor = None) -> torch.Tensor:
    """Mode ``mode`` of ``MODES`` on the (rows, cols) f32 product output
    ``y`` and its f32 bias: the bf16 operand (modes 'bias_bf16',
    'bias_gelu_bf16'), or ``x`` updated in place ('bias_residual')."""
    if mode not in MODES:
        raise ValueError(f'mode must be one of {MODES}')
    if route(y) == 'cpu':
        return plain(mode, y, bias, x)
    from buzzdetect_torch.ops import library
    if mode == 'bias_residual':
        library.bias_residual(x, y, bias)
        return x
    return library.bias_epilogue(y, bias, mode)


apply.launches = 0


def _launch_post_ln(x, y, bias, weight, norm_bias, out, alpha, eps):
    """``bz_post_ln`` on CUDA tensors: the implementation of
    ``buzzdetect::post_ln``; ``out`` the bf16 operand, or None."""
    rows, cols = x.shape
    for name, t, shape in (('y', y, x.shape), ('bias', bias, (cols,)),
                           ('weight', weight, (cols,)),
                           ('norm_bias', norm_bias, (cols,)),
                           ('x', x, x.shape)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.shape != shape:
            raise ValueError(f'{name}: expected a contiguous float32 '
                             f'{tuple(shape)} tensor, got {t.dtype} '
                             f'{tuple(t.shape)}')
    if out is not None and (out.dtype != torch.bfloat16 or out.shape != x.shape
                            or not out.is_contiguous()):
        raise ValueError(f'out: expected a contiguous bfloat16 '
                         f'{tuple(x.shape)} tensor')
    LIBRARY.launch(load_kernels(), 'bz_post_ln', x.device, y.data_ptr(),
                   bias.data_ptr(), x.data_ptr(), weight.data_ptr(),
                   norm_bias.data_ptr(),
                   None if out is None else out.data_ptr(), rows, cols,
                   float(alpha), float(eps))


def post_ln(y: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
            weight: torch.Tensor, norm_bias: torch.Tensor, alpha: float,
            eps: float, bf16: bool):
    """x = LayerNorm(alpha x + (y + bias)) (``weight``, ``norm_bias``,
    ``eps``) over each row of the (rows, cols) f32 ``x``, in place, from the
    f32 product output ``y`` and its bias; returns the bf16 copy of the new
    x under ``bf16``, else None."""
    if route(y) == 'cpu':
        return post_ln_plain(y, bias, x, weight, norm_bias, alpha, eps, bf16)
    from buzzdetect_torch.ops import library
    out = torch.empty(x.shape, dtype=torch.bfloat16,
                      device=x.device) if bf16 else None
    library.post_ln(x, y, bias, weight, norm_bias, out, float(alpha),
                    float(eps))
    return out


post_ln.launches = {'post_ln': 0}
