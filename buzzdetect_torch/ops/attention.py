"""Fused softmax attention: CUDA kernel, plain version, wrapper.

``attention(qkv, heads)`` takes the qkv product's output as it is, a
``(B, n, 3 C)`` tensor with ``C = heads x d`` (q, k and v of head h at
columns ``h*d``, ``C + h*d`` and ``2C + h*d``, as timm's attention
reshapes it), and returns ``softmax(q k^T * scale) v`` of every head as
``(B, n, C)``, head h at columns ``h*d`` (the heads' outputs side by side,
as ``transpose(1, 2).reshape(B, n, C)`` lays them). Non-causal, no mask;
``scale`` defaults to ``1 / sqrt(d)``. The kernel takes d = 64 (AST's);
the plain version any d.

The dtype of ``qkv`` picks the function:

* bfloat16: q, k and v as bf16 operands, S = q k^T accumulated in f32, the
  softmax in f32, P rounded to bf16 as PV's operand, PV accumulated in f32,
  the output rounded to bf16 (what the next product, the attention's
  projection, takes as its operand);
* float32: exact f32 throughout.

On a CUDA tensor the wrapper calls the ``buzzdetect::attention`` custom
operator (``ops/library.py``), which launches ``csrc/attention.cu`` once and
counts the launch in ``attention.launches``; on a CPU tensor it computes
``attention_plain``. There is no other path.

``attention_blocked`` replays the bf16 kernel's schedule in PyTorch (tiles
of 64 keys, the masked tail, the running maximum and sum, P rounded at the
running maximum, one division at the end): the tests hold it against
``attention_plain``, which keeps the kernel's arithmetic checkable on a
machine without a card.
"""

import ctypes
import math
from functools import lru_cache

import torch

from buzzdetect_torch.ops.sepconv import _route, device_scope, exact_f32

HEAD_DIM = 64
# the bf16 kernel's tile of keys
BLOCK_KEYS = 64
DTYPES = (torch.float32, torch.bfloat16)


def head_dim(qkv: torch.Tensor, heads: int) -> int:
    """d of a (B, n, 3 heads d) qkv tensor."""
    three_c = qkv.shape[-1]
    if heads <= 0 or three_c % (3 * heads):
        raise ValueError(f'qkv: {three_c} columns are not 3 x {heads} heads')
    return three_c // (3 * heads)


def _split(qkv: torch.Tensor, heads: int):
    """(B, n, 3C) -> q, k, v, each (B, heads, n, d), in f32."""
    b, n, _ = qkv.shape
    x = qkv.to(torch.float32).reshape(b, n, 3, heads, head_dim(qkv, heads))
    return x.permute(2, 0, 3, 1, 4).unbind(0)


def _merge(o: torch.Tensor, dtype) -> torch.Tensor:
    """(B, heads, n, d) -> (B, n, heads d) in ``dtype``."""
    b, h, n, d = o.shape
    return o.transpose(1, 2).reshape(b, n, h * d).to(dtype)


def _scale(scale, d):
    return 1.0 / math.sqrt(d) if scale is None else float(scale)


def attention_plain(qkv: torch.Tensor, heads: int,
                    scale: float = None) -> torch.Tensor:
    """Plain version of ``attention``: S = q k^T * scale in f32 (TF32 off),
    softmax in f32; under bf16 P rounded to bf16 before PV and the output
    rounded to bf16."""
    exact_f32()
    if qkv.dtype not in DTYPES:
        raise ValueError(f'qkv: expected float32 or bfloat16, got {qkv.dtype}')
    q, k, v = _split(qkv, heads)
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2))
                      * _scale(scale, q.shape[-1]), dim=-1)
    if qkv.dtype == torch.bfloat16:
        p = p.to(torch.bfloat16).to(torch.float32)
    return _merge(torch.matmul(p, v), qkv.dtype)


def attention_blocked(qkv: torch.Tensor, heads: int, scale: float = None,
                      block: int = BLOCK_KEYS) -> torch.Tensor:
    """The bf16 kernel's schedule in PyTorch: keys in tiles of ``block``,
    those past n masked, a running row maximum m and sum l, the output
    rescaled by exp(m_old - m_new) at each tile, P = exp(S * scale - m)
    rounded to bf16 before PV (for bf16 input), l the sum of the f32 P, and
    O / l at the end."""
    exact_f32()
    q, k, v = _split(qkv, heads)
    n, d = q.shape[-2:]
    scale = _scale(scale, d)
    m = torch.full(q.shape[:-1] + (1,), -math.inf, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros_like(q)
    tiles = -(-n // block)
    for t in range(tiles):
        kt = torch.zeros(k.shape[:-2] + (block, d), device=k.device)
        vt = torch.zeros_like(kt)
        keys = min(block, n - t * block)
        kt[..., :keys, :] = k[..., t * block:t * block + keys, :]
        vt[..., :keys, :] = v[..., t * block:t * block + keys, :]
        s = torch.matmul(q, kt.transpose(-1, -2))
        s[..., keys:] = -math.inf
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp((m - m_new) * scale)
        p = torch.exp(s * scale - m_new * scale)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        if qkv.dtype == torch.bfloat16:
            p = p.to(torch.bfloat16).to(torch.float32)
        o = o * alpha + torch.matmul(p, vt)
        m = m_new
    return _merge(o / l, qkv.dtype)


def attention_flops(batch: int, n: int, heads: int) -> float:
    """QK^T and PV: 2 n^2 d multiply-adds a head, 4 n^2 d flops."""
    return 4.0 * batch * heads * n * n * HEAD_DIM


def attention_bytes(batch: int, n: int, heads: int, itemsize: int) -> float:
    """q, k, v read once and o written once."""
    return 4.0 * batch * heads * n * HEAD_DIM * itemsize


def attention_bound_s(batch: int, n: int, heads: int, dtype, peak: dict):
    """The least time of one launch on the card of ``peak`` ({'f32',
    'bf16', 'bytes'}): its flops at the dtype's product peak or its bytes
    at the memory's, the larger."""
    bf16 = dtype == torch.bfloat16
    flops = attention_flops(batch, n, heads) / peak['bf16' if bf16 else 'f32']
    return max(flops, attention_bytes(batch, n, heads, 2 if bf16 else 4)
               / peak['bytes'])


# --- kernel launch ---------------------------------------------------------------

@lru_cache(maxsize=None)
def load_kernels():
    """Build (once) and load ``csrc/attention.cu``; returns the ctypes
    library."""
    from buzzdetect_torch.ops import _build
    return bind(_build.load('attention'))


def bind(lib):
    """Declare the C interface of a library built from ``csrc/attention.cu``
    on ``lib`` (a ctypes CDLL); returns it."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.bz_attention.argtypes = [ptr, ptr, i32, i32, i32, i32, i32,
                                 ctypes.c_float, ptr]
    lib.bz_attention.restype = i32
    lib.bz_attention_error_string.argtypes = [i32]
    lib.bz_attention_error_string.restype = ctypes.c_char_p
    return lib


def _launch(qkv: torch.Tensor, heads: int, scale: float, lib=None):
    """(B, n, 3C) contiguous f32 or bf16 CUDA tensor -> (B, n, C) through
    ``bz_attention``: the CUDA implementation of ``buzzdetect::attention``."""
    lib = load_kernels() if lib is None else lib
    if qkv.dtype not in DTYPES or not qkv.is_contiguous() or qkv.dim() != 3:
        raise ValueError(f'qkv: expected a contiguous (B, n, 3C) float32 or '
                         f'bfloat16 tensor, got {qkv.dtype} '
                         f'{tuple(qkv.shape)}')
    b, n, three_c = qkv.shape
    if three_c != 3 * heads * HEAD_DIM:
        raise ValueError(f'the attention kernel takes heads of {HEAD_DIM}: '
                         f'{three_c} columns are not 3 x {heads} x '
                         f'{HEAD_DIM}')
    out = torch.empty((b, n, heads * HEAD_DIM), dtype=qkv.dtype,
                      device=qkv.device)
    with device_scope(qkv.device):
        code = lib.bz_attention(qkv.data_ptr(), out.data_ptr(),
                                DTYPES.index(qkv.dtype), b, n, heads,
                                HEAD_DIM, float(scale),
                                torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f'bz_attention failed: CUDA error {code} '
                           f'({lib.bz_attention_error_string(code).decode()})')
    return out


def attention(qkv: torch.Tensor, heads: int,
              scale: float = None) -> torch.Tensor:
    """(B, n, 3C) qkv -> (B, n, C) attention output in qkv's dtype (f32 or
    bf16); see the module's docstring."""
    if qkv.dim() != 3:
        raise ValueError(f'expected a (B, n, 3C) tensor, got '
                         f'{tuple(qkv.shape)}')
    if _route(qkv) == 'cpu':
        return attention_plain(qkv, heads, scale)
    from buzzdetect_torch.ops import library
    return library.attention(qkv.contiguous(), heads,
                             _scale(scale, head_dim(qkv, heads)))


attention.launches = 0
