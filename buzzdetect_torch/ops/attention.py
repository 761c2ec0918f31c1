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

``attention_relpos(qkv, heads, rel, gate)`` is BEATs' attention
(``models/beats.py``): each score q_i k_j * scale plus g_ih rel[h, j - i +
n - 1], with ``rel`` a (heads, 2n - 1) f32 bias row a head and the gate
g_ih = u0 (u1 a_h - 1) + 2, (u0, u1) = sigmoid(G q_i + c), from ``gate``,
the f32 vector G (2 x d) | c (2) | a (heads); q is the query as the
operand holds it (bf16 under bf16). On a CUDA tensor it calls
``buzzdetect::attention_relpos``, the same kernels' ``RELPOS``
instantiation, and counts the launch in
``attention_relpos.launches['attention_relpos']``; on a CPU tensor
``attention_relpos_plain``.

``attention_blocked`` replays the bf16 kernel's schedule in PyTorch (tiles
of 64 keys, the masked tail, the running maximum and sum, P rounded at the
running maximum, one division at the end): the tests hold it against
``attention_plain``, which keeps the kernel's arithmetic checkable on a
machine without a card.
"""

import math

import torch

from buzzdetect_torch.ops.common import (
    F32, I32, PTR, Library, exact_f32, route)

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


def relpos_gate(q: torch.Tensor, gate: torch.Tensor,
                heads: int) -> torch.Tensor:
    """(B, heads, n, d) f32 queries -> (B, heads, n) gates u0 (u1 a_h - 1)
    + 2, (u0, u1) = sigmoid(G q + c), ``gate`` = G (2 x d) | c (2) | a
    (heads)."""
    d = q.shape[-1]
    g = gate[:2 * d].view(2, d)
    u = torch.sigmoid(torch.matmul(q, g.t()) + gate[2 * d:2 * d + 2])
    a = gate[2 * d + 2:2 * d + 2 + heads].view(1, heads, 1)
    return u[..., 0] * (u[..., 1] * a - 1.0) + 2.0


def relpos_bias(rel: torch.Tensor, n: int) -> torch.Tensor:
    """(heads, 2n - 1) bias rows -> (heads, n, n): [h, i, j] = rel[h, j - i
    + n - 1]."""
    idx = (torch.arange(n, device=rel.device)[None, :]
           - torch.arange(n, device=rel.device)[:, None] + n - 1)
    return rel[:, idx]


def attention_relpos_plain(qkv: torch.Tensor, heads: int, rel: torch.Tensor,
                           gate: torch.Tensor,
                           scale: float = None) -> torch.Tensor:
    """Plain version of ``attention_relpos``: S = q k^T * scale + g rel in
    f32 (TF32 off), softmax in f32; under bf16 P rounded to bf16 before PV
    and the output rounded to bf16."""
    exact_f32()
    if qkv.dtype not in DTYPES:
        raise ValueError(f'qkv: expected float32 or bfloat16, got {qkv.dtype}')
    q, k, v = _split(qkv, heads)
    n = q.shape[-2]
    g = relpos_gate(q, gate, heads)
    s = (torch.matmul(q, k.transpose(-1, -2)) * _scale(scale, q.shape[-1])
         + g[..., None] * relpos_bias(rel, n))
    p = torch.softmax(s, dim=-1)
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

# the C interface of csrc/attention.cu
LIBRARY = Library('attention', {
    'bz_attention': (I32, [PTR, PTR, I32, I32, I32, I32, I32, F32, PTR]),
    'bz_attention_relpos': (I32, [PTR, PTR, I32, I32, I32, I32, I32, F32,
                                  PTR, PTR, PTR]),
}, errors='bz_attention_error_string')
load_kernels = LIBRARY.load


def _launch(qkv: torch.Tensor, heads: int, scale: float, lib=None,
            rel: torch.Tensor = None, gate: torch.Tensor = None):
    """(B, n, 3C) contiguous f32 or bf16 CUDA tensor -> (B, n, C) through
    ``bz_attention``: the CUDA implementation of ``buzzdetect::attention``;
    with ``rel`` and ``gate`` through ``bz_attention_relpos``, that of
    ``buzzdetect::attention_relpos``."""
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
    args = (qkv.data_ptr(), out.data_ptr(), DTYPES.index(qkv.dtype), b, n,
            heads, HEAD_DIM, float(scale))
    if rel is None:
        LIBRARY.launch(lib, 'bz_attention', qkv.device, *args)
        return out
    for name, t, shape in (('rel', rel, (heads, 2 * n - 1)),
                           ('gate', gate, (2 * HEAD_DIM + 2 + heads,))):
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or tuple(t.shape) != shape or t.device != qkv.device):
            raise ValueError(f'{name}: expected a contiguous float32 '
                             f'{shape} tensor on {qkv.device}, got '
                             f'{t.dtype} {tuple(t.shape)} on {t.device}')
    LIBRARY.launch(lib, 'bz_attention_relpos', qkv.device, *args,
                   rel.data_ptr(), gate.data_ptr())
    return out


def attention(qkv: torch.Tensor, heads: int,
              scale: float = None) -> torch.Tensor:
    """(B, n, 3C) qkv -> (B, n, C) attention output in qkv's dtype (f32 or
    bf16); see the module's docstring."""
    if qkv.dim() != 3:
        raise ValueError(f'expected a (B, n, 3C) tensor, got '
                         f'{tuple(qkv.shape)}')
    if route(qkv) == 'cpu':
        return attention_plain(qkv, heads, scale)
    from buzzdetect_torch.ops import library
    return library.attention(qkv.contiguous(), heads,
                             _scale(scale, head_dim(qkv, heads)))


attention.launches = 0


def attention_relpos(qkv: torch.Tensor, heads: int, rel: torch.Tensor,
                     gate: torch.Tensor, scale: float = None) -> torch.Tensor:
    """(B, n, 3C) qkv -> (B, n, C) attention output in qkv's dtype, each
    score plus the gated relative-position bias; see the module's
    docstring."""
    if qkv.dim() != 3:
        raise ValueError(f'expected a (B, n, 3C) tensor, got '
                         f'{tuple(qkv.shape)}')
    if route(qkv) == 'cpu':
        return attention_relpos_plain(qkv, heads, rel, gate, scale)
    from buzzdetect_torch.ops import library
    return library.attention_relpos(qkv.contiguous(), heads, rel, gate,
                                    _scale(scale, head_dim(qkv, heads)))


attention_relpos.launches = {'attention_relpos': 0}
