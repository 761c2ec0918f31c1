"""The hand kernels as ``torch.library`` custom operators.

``buzzdetect::layer1``, ``buzzdetect::fused_front``,
``buzzdetect::fused_tail``, ``buzzdetect::log_mel``,
``buzzdetect::attention``, ``buzzdetect::attention_relpos``,
``buzzdetect::bias_epilogue``, ``buzzdetect::bias_residual`` and
``buzzdetect::post_ln`` are the one route to the kernels of
``csrc/layer1.cu``, ``csrc/sepconv.cu``, ``csrc/logmel.cu``,
``csrc/attention.cu`` and ``csrc/epilogue.cu``: the wrappers of
``ops/layer1.py``, ``ops/sepconv.py``, ``ops/logmel.py``,
``ops/attention.py`` and ``ops/epilogue.py`` call them on a CUDA tensor,
and a
``torch.export`` program records them by name, so a serving artifact
(``models/export.py``) runs the same kernels. The JAX package has no
counterpart: its ``conv='pallas'`` export bakes the Mosaic kernel into the
StableHLO itself.

Each operator has a CUDA implementation, which calls the existing launcher
(``sepconv._launch``, ``logmel._launch_operands``) and counts the launch on
the wrapper's ``launches`` (``common.count_launch``), and a fake
implementation, which gives the output's shape and dtype for tracing. None
has a CPU implementation: on the CPU the wrappers compute their plain
versions (``common.route``), and an operator called on CPU tensors
raises ``NotImplementedError``.

An operator takes only tensors, lists of tensors and scalars, so the
packed conv operands travel as one flat ``Tensor[]`` (four per layer, in
``sepconv._check``'s order: depthwise taps, depthwise bias, the mode's
pointwise operand, pointwise bias), the layer range as ints and the mode
as a string; the log-mel's constants (``logmel._operands``: the window and
twiddle tables, the mel matrix) as a ``Tensor[]``, with the frame geometry
as ints and ``log_offset`` as a float. The log-mel takes f32 samples or
the int16 wire; ``geometry='kaldi'`` selects the Kaldi fbank, whose floor
rides in ``log_offset`` and whose normalisation in ``shift`` and
``scale``. The attention takes the (B, n, 3C) qkv product, the head count
and the scale.
"""

import torch
from torch import Tensor

from buzzdetect_torch.ops import attention as attention_lib
from buzzdetect_torch.ops import epilogue, logmel, sepconv
from buzzdetect_torch.ops import layer1 as layer1_lib
from buzzdetect_torch.ops.common import count_launch

NAMESPACE = 'buzzdetect'


def _layers(operands, specs):
    """The flat ``Tensor[]`` back into ``sepconv._check``'s per-layer
    (dw, dw_b, pw, pw_b) tuples."""
    if len(operands) != 4 * len(specs):
        raise ValueError(f'expected {4 * len(specs)} operands for '
                         f'{len(specs)} layers, got {len(operands)}')
    return [tuple(operands[4 * i:4 * i + 4]) for i in range(len(specs))]


def _stack_shape(x, specs, gap):
    last = specs[-1]
    if gap:
        return (x.shape[0], last.c_out)
    return (x.shape[0], last.h_out * last.w_out, last.c_out)


@torch.library.custom_op(f'{NAMESPACE}::layer1', mutates_args=(),
                         device_types='cuda')
def layer1(patches: Tensor, kernel: Tensor, bias: Tensor, mode: str
           ) -> Tensor:
    """YAMNet's layer 1 on (B, 96, 64) contiguous f32 patches, the
    (32, 1, 3, 3) OIHW kernel and the (32) bias -> (B, 48, 32, 32) NHWC
    f32 in ``mode``."""
    out = layer1_lib._launch(kernel, bias, patches, mode)
    count_launch(layer1_lib.layer1)
    return out


@layer1.register_fake
def _(patches, kernel, bias, mode):
    return patches.new_empty((patches.shape[0], *layer1_lib.OUT_SHAPE))


@torch.library.custom_op(f'{NAMESPACE}::fused_front', mutates_args=(),
                         device_types='cuda')
def fused_front(x: Tensor, operands: list[Tensor], start_layer: int,
                stop_layer: int, mode: str) -> Tensor:
    """Layers [start_layer, stop_layer) of the separable-conv stack on
    (B, H, W, C) NHWC f32 -> (B, Ho*Wo, F) in ``mode``."""
    specs = sepconv.tail_specs(start_layer, stop_layer)
    out, wide = sepconv._launch(_layers(operands, specs), x, specs, False,
                                mode)
    count_launch(sepconv.fused_front, mode, (start_layer, stop_layer),
                 x.shape[0], {'mma_wide': wide})
    return out


@fused_front.register_fake
def _(x, operands, start_layer, stop_layer, mode):
    specs = sepconv.tail_specs(start_layer, stop_layer)
    return x.new_empty(_stack_shape(x, specs, False))


@torch.library.custom_op(f'{NAMESPACE}::fused_tail', mutates_args=(),
                         device_types='cuda')
def fused_tail(x: Tensor, operands: list[Tensor], start_layer: int,
               stop_layer: int, gap: bool, mode: str) -> Tensor:
    """Layers [start_layer, stop_layer) on (B, H, W, C) NHWC f32 ->
    (B, F) pooled with ``gap``, else (B, Ho*Wo, F), in ``mode``."""
    specs = sepconv.tail_specs(start_layer, stop_layer)
    out, wide = sepconv._launch(_layers(operands, specs), x, specs, gap,
                                mode)
    count_launch(sepconv.fused_tail, mode, (start_layer, stop_layer),
                 x.shape[0], {'mma_wide': wide})
    return out


@fused_tail.register_fake
def _(x, operands, start_layer, stop_layer, gap, mode):
    specs = sepconv.tail_specs(start_layer, stop_layer)
    return x.new_empty(_stack_shape(x, specs, gap))


def _log_mel_frames(n, window, hop):
    if (window, hop) != (logmel.WINDOW, logmel.HOP):
        raise ValueError(f'the fused log-mel kernel takes {logmel.WINDOW}-'
                         f'sample frames at hop {logmel.HOP}, got {window} '
                         f'at {hop}')
    return 1 + (n - window) // hop


@torch.library.custom_op(f'{NAMESPACE}::log_mel', mutates_args=(),
                         device_types='cuda')
def log_mel(waveform: Tensor, constants: list[Tensor], window: int,
            hop: int, log_offset: float, geometry: str = 'yamnet',
            shift: float = 0.0, scale: float = 1.0,
            input_scale: float = 1.0) -> Tensor:
    """(B, n) contiguous f32 or int16 waveforms -> (B, n_frames, 64) f32
    log-mel; ``constants`` is ``[tables, mel]`` of ``logmel._operands``.
    ``geometry='kaldi'``: (B, n_frames, 128), (log(max(fbank, log_offset))
    + shift) / scale of the samples (in [-1, 1]) times ``input_scale``."""
    _log_mel_frames(waveform.shape[-1], window, hop)
    tables, mel = constants
    out = logmel._launch_operands(waveform, tables, mel, log_offset,
                                  kind=geometry, shift=shift, divisor=scale,
                                  input_scale=input_scale)
    count_launch(logmel.log_mel_spectrogram_fused)
    return out


@log_mel.register_fake
def _(waveform, constants, window, hop, log_offset, geometry='yamnet',
      shift=0.0, scale=1.0, input_scale=1.0):
    n_frames = _log_mel_frames(waveform.shape[-1], window, hop)
    return waveform.new_empty((waveform.shape[0], n_frames,
                               logmel.GEOMETRIES[geometry][-1]),
                              dtype=torch.float32)


@torch.library.custom_op(f'{NAMESPACE}::attention', mutates_args=(),
                         device_types='cuda')
def attention(qkv: Tensor, heads: int, scale: float) -> Tensor:
    """(B, n, 3 heads 64) contiguous f32 or bf16 -> (B, n, heads 64) in the
    same dtype: softmax(q k^T * scale) v of each head."""
    out = attention_lib._launch(qkv, heads, scale)
    count_launch(attention_lib.attention)
    return out


@attention.register_fake
def _(qkv, heads, scale):
    b, n, _ = qkv.shape
    return qkv.new_empty((b, n, heads * attention_lib.HEAD_DIM))


@torch.library.custom_op(f'{NAMESPACE}::attention_relpos', mutates_args=(),
                         device_types='cuda')
def attention_relpos(qkv: Tensor, heads: int, rel: Tensor, gate: Tensor,
                     scale: float) -> Tensor:
    """As ``attention``, each score plus the gated relative-position bias:
    ``rel`` (heads, 2n - 1) f32, ``gate`` G (2 x 64) | c (2) | a (heads)
    f32 (``ops/attention.attention_relpos``)."""
    out = attention_lib._launch(qkv, heads, scale, rel=rel, gate=gate)
    count_launch(attention_lib.attention_relpos, 'attention_relpos')
    return out


@attention_relpos.register_fake
def _(qkv, heads, rel, gate, scale):
    b, n, _ = qkv.shape
    return qkv.new_empty((b, n, heads * attention_lib.HEAD_DIM))


@torch.library.custom_op(f'{NAMESPACE}::bias_epilogue', mutates_args=(),
                         device_types='cuda')
def bias_epilogue(y: Tensor, bias: Tensor, mode: str) -> Tensor:
    """(rows, cols) f32 product output and (cols) f32 bias -> the bf16
    operand of mode 'bias_bf16' or 'bias_gelu_bf16' (``ops/epilogue``)."""
    out = torch.empty(y.shape, dtype=torch.bfloat16, device=y.device)
    epilogue._launch(mode, y, bias, out)
    count_launch(epilogue.apply)
    return out


@bias_epilogue.register_fake
def _(y, bias, mode):
    return y.new_empty(y.shape, dtype=torch.bfloat16)


@torch.library.custom_op(f'{NAMESPACE}::bias_residual', mutates_args=('x',),
                         device_types='cuda')
def bias_residual(x: Tensor, y: Tensor, bias: Tensor) -> None:
    """x += y + bias, in place: (rows, cols) f32 x and y, (cols) f32 bias."""
    epilogue._launch('bias_residual', y, bias, x)
    count_launch(epilogue.apply)


@bias_residual.register_fake
def _(x, y, bias):
    return None


@torch.library.custom_op(f'{NAMESPACE}::post_ln', mutates_args=('x', 'out'),
                         device_types='cuda')
def post_ln(x: Tensor, y: Tensor, bias: Tensor, weight: Tensor,
            norm_bias: Tensor, out: Tensor | None, alpha: float,
            eps: float) -> None:
    """x = LayerNorm(alpha x + (y + bias)) in place on (rows, cols) f32 x;
    ``out`` (rows, cols) bf16, or None, the same values rounded
    (``ops/epilogue.post_ln``)."""
    epilogue._launch_post_ln(x, y, bias, weight, norm_bias, out, alpha, eps)
    count_launch(epilogue.post_ln, 'post_ln')


@post_ln.register_fake
def _(x, y, bias, weight, norm_bias, out, alpha, eps):
    return None
