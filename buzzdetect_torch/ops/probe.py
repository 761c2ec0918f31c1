"""The capability probe's kernels: CUDA wrappers, plain versions, counters.

Counterpart of the kernels in ``tools/mosaic_capability_probe.py``
(``run``, ``case_collapsed_dot``, ``case_dot_high``,
``case_dot_high_emulated``), with the CUDA sources in ``csrc/probe.cu`` (see
the note at the top of that file):

* ``remap_batch(items)``: a list of ``(case, x, w)`` items, each one of the
  20 layout cases of ``CASES`` (stride-2 slices, reshapes, rolls,
  pad-shifts, a transpose, a row gather, masks, an outer broadcast
  product; ``w`` is None but for ``outer_broadcast_mul``), in one launch;
  ``remap(case, x, w=None)`` is a batch of one;
* ``dot_f32(a, w)``: (M, K) @ (K, N) in exact f32 (FFMA);
* ``dot_high(a, w)``: the same product at HIGH on the tensor cores, both f32
  operands split into bf16 hi/lo and hi*hi + hi*lo + lo*hi summed in f32;
* ``dot_high_emulated(a, w_hilo)``: the same function on the tensor cores
  as the conv kernels' HIGH mode runs it, from the (2, K, N) bf16 hi/lo
  weight of ``sepconv.pack_pointwise(w, 'high')``, with hi*hi and
  hi*lo + lo*hi in two f32 accumulators;
* ``fma_chain(x, steps, a, b)``: ``v = fma(v, a, b)`` applied ``steps``
  times to every element, the f32 peak probe of ``tools/roofline.py``.

On a CUDA tensor each wrapper launches its kernel and adds one to its
``launches`` counter (``remap_batch`` to ``remap.launches``, once per
batch); on a CPU tensor it computes the plain PyTorch version. There is no
other path.
"""

import ctypes
import itertools
import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from buzzdetect_torch.ops.sepconv import (
    _count_launch, _pointwise_plain, _route, device_scope, exact_f32,
    pack_pointwise)

# The 20 layout cases, in the order of csrc/probe.cu's case ids: name ->
# the plain version, a torch expression of the input (and, for
# outer_broadcast_mul, the weight).
CASES = {
    'stride_lane': lambda x: x[:, :, ::2],
    'stride_sublane': lambda x: x[:, ::2, :],
    'stride_leading': lambda x: x[::2],
    'reshape_leading_split': lambda x: x.reshape(
        x.shape[0] // 2, 2, *x.shape[1:])[:, 0],
    'reshape_leading_merge': lambda x: x.reshape(
        x.shape[0] * x.shape[1], *x.shape[2:]),
    'collapse_to_2d': lambda x: x.reshape(-1, x.shape[-1]),
    'split_minor': lambda x: x.reshape(x.shape[0], -1, 128),
    'roll_sublane': lambda x: torch.roll(x, 1, 1),
    'roll_lane': lambda x: torch.roll(x, 128, 2),
    'pad_slice_shift': lambda x: F.pad(x, (0, 0, 1, 0))[:, :-1, :],
    'transpose_minor': lambda x: x.transpose(1, 2),
    'row_gather': lambda x: x[:, ::2, ::2].reshape(-1, x.shape[-1]),
    'iota_mask': lambda x: torch.where(
        (torch.arange(x.shape[1], device=x.device) % 4 == 0)[None, :, None],
        0.0, x),
    'iota_mod24': lambda x: torch.where(
        (torch.arange(x.shape[1], device=x.device) % 3 == 0)[None, :, None],
        0.0, x),
    'split_sublane': lambda x: x.reshape(
        x.shape[0], x.shape[1] // 2, 2, x.shape[2])[:, :, 0],
    'roll_lane_32': lambda x: torch.roll(x, 32, 2),
    'pad_slice_lane': lambda x: F.pad(x, (1, 0))[:, :, :-1],
    'split_minor_small': lambda x: x.reshape(*x.shape[:2], -1, 32),
    'swap_nonminor_merge': lambda x: x.reshape(
        x.shape[0], x.shape[1], -1, 128).transpose(1, 2).reshape(
        -1, x.shape[1], 128),
    'outer_broadcast_mul': lambda x, w: x * w,
}
_CASE_ID = {name: i for i, name in enumerate(CASES)}
# the input's rank for each case (the kernels index 4 dims, leading ones)
_RANK = {**dict.fromkeys(CASES, 3),
         'stride_leading': 4, 'reshape_leading_split': 4,
         'reshape_leading_merge': 4, 'collapse_to_2d': 4, 'row_gather': 4,
         'split_minor': 2}


# the most items one remap_batch launch takes (csrc/probe.cu: MAX_REMAP,
# the kernel's table of cases)
MAX_BATCH = 32


def _check_case(case, x, w, where=''):
    """Raise ValueError (its message led by ``where``) unless ``case``
    takes ``x`` and ``w``."""
    if case not in CASES:
        raise ValueError(f'{where}unknown layout case {case!r}; one of '
                         f'{list(CASES)}')
    if x.dtype != torch.float32 or x.dim() != _RANK[case]:
        raise ValueError(f'{where}{case}: expected a {_RANK[case]}-d float32 '
                         f'input, got {x.dtype} {tuple(x.shape)}')
    if (w is not None) != (case == 'outer_broadcast_mul'):
        raise ValueError(f'{where}{case}: a weight is taken by '
                         f'outer_broadcast_mul and nothing else')
    if w is not None and (w.dtype != torch.float32
                          or tuple(w.shape) != (x.shape[0], 1, 1)
                          or w.device != x.device):
        raise ValueError(f'{where}{case}: expected a float32 '
                         f'({x.shape[0]}, 1, 1) weight on {x.device}, got '
                         f'{w.dtype} {tuple(w.shape)} on {w.device}')


def remap_plain(case: str, x: torch.Tensor, w: torch.Tensor = None):
    """Plain version of ``remap``: the case's torch expression."""
    _check_case(case, x, w)
    out = CASES[case](x, w) if w is not None else CASES[case](x)
    return out.contiguous()


def _check_dot(a, w, planes):
    """(m, n, k) of a product a (M, K) @ w, w as (K, N) f32 or (planes,
    K, N) bf16."""
    w_dtype = torch.float32 if planes is None else torch.bfloat16
    lead = () if planes is None else (planes,)
    if a.dim() != 2 or a.dtype != torch.float32:
        raise ValueError(f'expected a (M, K) float32 activation, got '
                         f'{a.dtype} {tuple(a.shape)}')
    m, k = a.shape
    if (w.dtype != w_dtype or w.dim() != 2 + len(lead)
            or tuple(w.shape[:-1]) != lead + (k,)):
        raise ValueError(f'expected a {w_dtype} {lead + (k,)} + (N,) weight, '
                         f'got {w.dtype} {tuple(w.shape)}')
    if w.device != a.device:
        raise ValueError(f'weight on {w.device}, activation on {a.device}')
    n = w.shape[-1]
    if m == 0 or n % 64 or k % 32:
        raise ValueError(f'the product kernels take M > 0, N a multiple of '
                         f'64 and K of 32; got M={m}, N={n}, K={k}')
    return m, n, k


def dot_f32_plain(a, w):
    """Plain version of ``dot_f32``: one f32 matrix product, TF32 off."""
    _check_dot(a, w, None)
    exact_f32()
    return _pointwise_plain(a, w, 'highest')


def dot_high_plain(a, w):
    """Plain version of ``dot_high``: the weight split by
    ``pack_pointwise(w, 'high')``, then the emulated-HIGH product."""
    _check_dot(a, w, None)
    exact_f32()
    return _pointwise_plain(a, pack_pointwise(w, 'high'), 'high')


def dot_high_emulated_plain(a, w_hilo):
    """Plain version of ``dot_high_emulated``."""
    _check_dot(a, w_hilo, 2)
    exact_f32()
    return _pointwise_plain(a, w_hilo, 'high')


def fma_chain_plain(x, steps, a, b):
    """Plain version of ``fma_chain``, in float64 on the kernel's f32
    constants (one rounding, to f32, at the end; the kernel rounds once per
    step)."""
    _check_fma(x, steps)
    a, b = float(np.float32(a)), float(np.float32(b))
    v = x.to(torch.float64)
    for _ in range(steps):
        v = v * a + b
    return v.to(torch.float32)


def _check_fma(x, steps):
    if x.dtype != torch.float32 or x.dim() != 1 or x.numel() % 4 or steps < 0:
        raise ValueError(f'expected a 1-d float32 input of a multiple of 4 '
                         f'elements and steps >= 0, got {x.dtype} '
                         f'{tuple(x.shape)}, steps={steps}')


# --- kernel launch ---------------------------------------------------------------

@lru_cache(maxsize=None)
def load_kernels():
    """Build (once) and load ``csrc/probe.cu``; returns the ctypes library."""
    from buzzdetect_torch.ops import _build
    return bind(_build.load('probe'))


_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
# the C interface of csrc/probe.cu: name -> argument types; every pointer
# and the stream (the last argument) pass as c_void_p, since an untyped int
# argument would be cut to 32 bits
_INTERFACE = {
    'bz_probe_remap': [_I32, _PTR, _PTR, _PTR, _PTR, ctypes.c_longlong,
                       _PTR],
    'bz_probe_remap_batch': [_I32, _PTR, _PTR, _PTR, _PTR],
    'bz_probe_dot_f32': [_PTR, _PTR, _PTR, _I32, _I32, _I32, _PTR],
    'bz_probe_dot_high': [_PTR, _PTR, _PTR, _I32, _I32, _I32, _PTR],
    'bz_probe_dot_high_emulated': [_PTR, _PTR, _PTR, _I32, _I32, _I32,
                                   _PTR],
    'bz_probe_fma_chain': [_PTR, _PTR, ctypes.c_longlong, _I32,
                           ctypes.c_float, ctypes.c_float, _PTR],
}


def bind(lib):
    """Declare the C interface of a library built from ``csrc/probe.cu`` on
    ``lib`` (a ctypes CDLL); returns it. A function that an older build of
    the source lacks (``bz_probe_remap_batch``) stays undeclared, and
    calling it raises AttributeError."""
    for name, argtypes in _INTERFACE.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = _I32
    lib.bz_probe_error_string.argtypes = [_I32]
    lib.bz_probe_error_string.restype = ctypes.c_char_p
    return lib


def _call(name, device, *args, lib=None):
    """Run ``lib.<name>(*args, stream)`` (this checkout's library, or
    ``lib``, another build of it) on ``device``'s current stream; raises on
    any CUDA error code."""
    lib = load_kernels() if lib is None else lib
    with device_scope(device):
        code = getattr(lib, name)(*args,
                                  torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f'{name} failed: CUDA error {code} '
                           f'({lib.bz_probe_error_string(code).decode()})')


def _contiguous(*tensors):
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('the probe kernels take contiguous tensors')


@lru_cache(maxsize=None)
def _out_shape(case, x_shape, w_shape):
    """The output shape of ``case`` on inputs of these shapes: the plain
    version's, traced once on meta tensors."""
    meta = [torch.empty(x_shape, device='meta')]
    if w_shape is not None:
        meta.append(torch.empty(w_shape, device='meta'))
    return tuple(remap_plain(case, *meta).shape)


def _padded(shape):
    return [1] * (4 - len(shape)) + list(shape)


def _strides(shape):
    """The strides of a contiguous tensor of ``shape``."""
    strides, step = [], 1
    for size in reversed(shape):
        strides.insert(0, step)
        step *= size
    return tuple(strides)


@lru_cache(maxsize=None)
def _batch_table(key):
    """For a batch's ``((case, x shape, w shape or None), ...)``: the
    kernel's case ids and dims (input then output shape, padded to 4 with
    leading ones) as ctypes arrays; each output's shape, strides and offset
    in one buffer for all of them (a multiple of 4 elements, so every output
    starts 16-byte aligned); and the buffer's size. Cached by shape, so a
    repeated sweep builds only its pointers. Raises ValueError naming the
    item whose input or output has 2**31 elements or more."""
    shapes = []
    for i, (case, x_shape, w_shape) in enumerate(key):
        out = _out_shape(case, x_shape, w_shape)
        if max(math.prod(x_shape), math.prod(out)) >= 2 ** 31:
            raise ValueError(f'item {i}: {case}: the kernel indexes in 32 '
                             f'bits; input {x_shape}, output {out}')
        shapes.append(out)
    ids = (ctypes.c_int * len(key))(*(_CASE_ID[case] for case, *_ in key))
    dims = (ctypes.c_int * (8 * len(key)))(*itertools.chain.from_iterable(
        _padded(x_shape) + _padded(out)
        for (_case, x_shape, _w), out in zip(key, shapes)))
    outs, total = [], 0
    for shape in shapes:
        outs.append((shape, _strides(shape), total))
        total += -(-math.prod(shape) // 4) * 4
    return ids, dims, tuple(outs), total


def remap_batch(items):
    """The layout cases ``items`` (a list of ``(case, x, w)``, ``w`` None
    but for ``outer_broadcast_mul``), all in one launch; returns their
    outputs in order (on the card, views of one new buffer). Every item must
    lie on one device, with inputs and outputs of under 2**31 elements, and
    a batch holds 1 to ``MAX_BATCH`` items; anything else raises ValueError
    naming the item."""
    items = list(items)
    if not 0 < len(items) <= MAX_BATCH:
        raise ValueError(f'remap_batch takes 1 to {MAX_BATCH} items, got '
                         f'{len(items)}')
    device = items[0][1].device
    key = []
    for i, (case, x, w) in enumerate(items):
        _check_case(case, x, w, f'item {i}: ')
        if x.device != device:
            raise ValueError(f'item {i}: {case} on {x.device}, item 0 on '
                             f'{device}: a batch lies on one device')
        key.append((case, tuple(x.shape),
                    None if w is None else tuple(w.shape)))
    ids, dims, outs, total = _batch_table(tuple(key))
    if _route(items[0][1]) == 'cpu':
        return [remap_plain(case, x, w) for case, x, w in items]
    _contiguous(*(t for _case, x, w in items
                  for t in (x, w) if t is not None))
    buf = torch.empty(total, dtype=torch.float32, device=device)
    base = buf.data_ptr()
    ptrs = (ctypes.c_int64 * (3 * len(items)))(*itertools.chain.from_iterable(
        (x.data_ptr(), 0 if w is None else w.data_ptr(), base + 4 * offset)
        for (_case, x, w), (_shape, _stride, offset) in zip(items, outs)))
    _call('bz_probe_remap_batch', device, len(items), ids, ptrs, dims)
    _count_launch(remap)
    return [buf.as_strided(shape, stride, offset)
            for shape, stride, offset in outs]


def remap(case: str, x: torch.Tensor, w: torch.Tensor = None):
    """Layout case ``case`` of ``CASES`` applied to ``x`` (and ``w``): a
    batch of one."""
    return remap_batch([(case, x, w)])[0]


# the product kernels: name -> the weight's bf16 planes (None: f32)
_DOT_PLANES = {'dot_f32': None, 'dot_high': None, 'dot_high_emulated': 2}


def _launch_dot(name, a, w, m, n, k, lib=None):
    _contiguous(a, w)
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    _call(f'bz_probe_{name}', a.device, a.data_ptr(), w.data_ptr(),
          out.data_ptr(), m, n, k, lib=lib)
    return out


def launch_dot(name, a, w, lib=None):
    """Product kernel ``name`` (``dot_f32``, ``dot_high`` or
    ``dot_high_emulated``) of this checkout's library (or of ``lib``,
    another build of it) on CUDA operands; returns the new output."""
    m, n, k = _check_dot(a, w, _DOT_PLANES[name])
    return _launch_dot(name, a, w, m, n, k, lib)


def dot_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) in exact f32."""
    m, n, k = _check_dot(a, w, None)
    if _route(a) == 'cpu':
        return dot_f32_plain(a, w)
    out = _launch_dot('dot_f32', a, w, m, n, k)
    _count_launch(dot_f32)
    return out


def dot_high(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) at HIGH on the tensor cores (f32 operands)."""
    m, n, k = _check_dot(a, w, None)
    if _route(a) == 'cpu':
        return dot_high_plain(a, w)
    out = _launch_dot('dot_high', a, w, m, n, k)
    _count_launch(dot_high)
    return out


def dot_high_emulated(a: torch.Tensor, w_hilo: torch.Tensor) -> torch.Tensor:
    """(M, K) @ hi/lo (2, K, N) bf16 at emulated HIGH on the tensor
    cores."""
    m, n, k = _check_dot(a, w_hilo, 2)
    if _route(a) == 'cpu':
        return dot_high_emulated_plain(a, w_hilo)
    out = _launch_dot('dot_high_emulated', a, w_hilo, m, n, k)
    _count_launch(dot_high_emulated)
    return out


def fma_chain(x: torch.Tensor, steps: int, a: float, b: float):
    """Every element of the 1-d f32 ``x`` after ``steps`` of
    ``v = fma(v, a, b)``."""
    _check_fma(x, steps)
    if _route(x) == 'cpu':
        return fma_chain_plain(x, steps, a, b)
    _contiguous(x)
    out = torch.empty_like(x)
    _call('bz_probe_fma_chain', x.device, x.data_ptr(), out.data_ptr(),
          x.numel(), steps, a, b)
    _count_launch(fma_chain)
    return out


KERNELS = (remap, dot_f32, dot_high, dot_high_emulated, fma_chain)
for _kernel in KERNELS:
    _kernel.launches = 0
