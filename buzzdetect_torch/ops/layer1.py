"""YAMNet's layer 1 (a 3x3 stride-2 convolution from the log-mel patch to
32 channels, bias, ReLU): CUDA kernel, plain version, wrapper.

On a CUDA tensor ``layer1`` calls the ``buzzdetect::layer1`` custom
operator (``ops/library.py``), which launches ``csrc/layer1.cu`` once and
counts it in ``layer1.launches``; on a CPU tensor it computes the plain
version, ``plain``: TF-SAME padding, ``F.conv2d`` (TF32 off), bias, ReLU,
the NHWC permute. There is no other path. ``replay`` repeats the kernel's
own steps in PyTorch (its tap order and each rounding), so that the kernel
can be held to it bit for bit and the replay to the plain version within
the difference of two summation orders.

``mode`` is the conv kernels' (``sepconv.MODES``). ``'highest'`` and
``'high'`` compute exact f32 (for HIGH, exact f32 is what XLA computes on
the CPU oracle, and the layer has no 3-product form): one instantiation of
the kernel. ``'bf16'`` rounds the patches and the taps to bf16, sums the
products in f32 and rounds the output to bf16 (held in f32), as the JAX
package's ``packed_l1`` computes under bf16 compute: the other.
"""

from functools import lru_cache

import torch
import torch.nn.functional as F

from buzzdetect_torch.ops.common import (
    I32, PTR, Library, exact_f32, round_bf16, route)
from buzzdetect_torch.ops.sepconv import check_mode, same_pad

# a patch (frames x mel bands) and the layer's output (rows, columns,
# channels)
IN_SHAPE = (96, 64)
OUT_SHAPE = (48, 32, 32)
# the kernel's instantiation for each mode: 0 exact f32, 1 bf16
_MODE_CODE = {'highest': 0, 'high': 0, 'bf16': 1}
# output rows a block, largest first (csrc/layer1.cu takes these)
BAND_ROWS = (8, 4, 2, 1)
# blocks of 256 threads a launch gives each SM where the batch allows: two
# rounds of the four an SM holds at once at the kernel's 59 registers a
# thread
BLOCKS_PER_SM = 8


def plain(kernel: torch.Tensor, bias: torch.Tensor, patches: torch.Tensor,
          mode: str = 'highest') -> torch.Tensor:
    """(B, 96, 64) patches -> (B, 48, 32, 32) NHWC: TF-SAME padding (bottom
    and right only), the (32, 1, 3, 3) OIHW ``kernel`` by ``F.conv2d``,
    bias, ReLU; in ``'bf16'`` the patches, the kernel and the output
    rounded to bf16."""
    exact_f32()
    x = patches.to(torch.float32)
    if mode == 'bf16':
        x, kernel = round_bf16(x), round_bf16(kernel)
    ph, pw = same_pad(x.shape[1], 2), same_pad(x.shape[2], 2)
    x = F.pad(x[:, None], (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(x, kernel, stride=2)
    y = torch.relu(y + bias[:, None, None])
    if mode == 'bf16':
        y = round_bf16(y)
    return y.permute(0, 2, 3, 1).contiguous()


def replay(kernel: torch.Tensor, bias: torch.Tensor, patches: torch.Tensor,
           mode: str = 'highest') -> torch.Tensor:
    """What ``csrc/layer1.cu`` computes, step by step in PyTorch: the nine
    products, each rounded to f32, summed from the first in the order
    ky = 0..2, kx = 0..2 (ky outer), then + bias, then ReLU; in ``'bf16'``
    the patches and taps rounded to bf16 first and the output after."""
    x = patches.to(torch.float32)
    k = kernel.reshape(OUT_SHAPE[2], 9)
    if _MODE_CODE[mode]:
        x, k = round_bf16(x), round_bf16(k)
    x = F.pad(x, (0, 1, 0, 1))                   # row 96, column 64: zero
    ho, wo, _ = OUT_SHAPE
    acc = None
    for j in range(9):
        ky, kx = divmod(j, 3)
        v = x[:, ky:ky + 2 * ho - 1:2, kx:kx + 2 * wo - 1:2, None]
        p = v * k[:, j]
        acc = p if acc is None else acc + p
    y = torch.relu(acc + bias)
    return round_bf16(y) if _MODE_CODE[mode] else y


def band_rows(batch: int, sms: int) -> int:
    """Output rows a block of the kernel owns at ``batch`` patches on a
    card of ``sms`` SMs: the largest of ``BAND_ROWS`` that still gives
    ``BLOCKS_PER_SM`` blocks an SM, else 1 (a small batch, as many blocks
    as it has output rows)."""
    for rows in BAND_ROWS:
        if batch * (OUT_SHAPE[0] // rows) >= BLOCKS_PER_SM * sms:
            return rows
    return BAND_ROWS[-1]


@lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# the C interface of csrc/layer1.cu
LIBRARY = Library('layer1', {
    'bz_layer1': (I32, [PTR] * 4 + [I32, I32, I32, PTR]),
}, errors='bz_layer1_error_string')
load_kernels = LIBRARY.load


def _check(kernel, bias, x, mode):
    """Raise on anything the kernel does not take: ``x`` must be (B, 96,
    64) contiguous f32 with B > 0, ``kernel`` (32, 1, 3, 3) and ``bias``
    (32) contiguous f32 on ``x``'s device, ``mode`` one of the modes."""
    check_mode(mode)
    if x.dim() != 3 or tuple(x.shape[1:]) != IN_SHAPE or x.shape[0] == 0:
        raise ValueError(f'expected (B, {IN_SHAPE[0]}, {IN_SHAPE[1]}) '
                         f'patches with B > 0, got {tuple(x.shape)}')
    for name, t, shape in (('patches', x, tuple(x.shape)),
                           ('kernel', kernel, (OUT_SHAPE[2], 1, 3, 3)),
                           ('bias', bias, (OUT_SHAPE[2],))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f'{name}: expected float32 {shape}, got '
                             f'{t.dtype} {tuple(t.shape)}')
        if not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
        if t.device != x.device:
            raise ValueError(f'{name} is on {t.device}, patches on '
                             f'{x.device}')


def _launch(kernel, bias, x, mode):
    """``bz_layer1`` on CUDA tensors, on the current stream: the operator's
    implementation. Returns the (B, 48, 32, 32) output; raises on any CUDA
    error code."""
    _check(kernel, bias, x, mode)
    if any(t.data_ptr() % 16 for t in (kernel, bias, x)):
        raise ValueError('the kernel reads 16-byte aligned tensors')
    lib = load_kernels()
    b = x.shape[0]
    out = torch.empty((b, *OUT_SHAPE), dtype=torch.float32, device=x.device)
    index = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    LIBRARY.launch(lib, 'bz_layer1', x.device, x.data_ptr(),
                   kernel.data_ptr(), bias.data_ptr(), out.data_ptr(), b,
                   band_rows(b, _sms(index)), _MODE_CODE[mode])
    return out


def layer1(kernel: torch.Tensor, bias: torch.Tensor, patches: torch.Tensor,
           mode: str = 'highest') -> torch.Tensor:
    """(B, 96, 64) f32 patches -> (B, 48, 32, 32) NHWC f32 layer-1
    activations in ``mode``: the kernel on a CUDA tensor, ``plain`` on a
    CPU tensor."""
    if route(patches) == 'cpu':
        check_mode(mode)
        return plain(kernel, bias, patches, mode)
    _check(kernel, bias, patches, mode)
    from buzzdetect_torch.ops import library
    return library.layer1(patches, kernel, bias, mode)


layer1.launches = 0
