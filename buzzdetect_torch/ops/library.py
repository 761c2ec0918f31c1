"""The hand kernels as ``torch.library`` custom operators.

``buzzdetect::fused_front``, ``buzzdetect::fused_tail`` and
``buzzdetect::log_mel`` are the one route to the kernels of
``csrc/sepconv.cu`` and ``csrc/logmel.cu``: the wrappers of
``ops/sepconv.py`` and ``ops/logmel.py`` call them on a CUDA tensor, and a
``torch.export`` program records them by name, so a serving artifact
(``models/export.py``) runs the same kernels. The JAX package has no
counterpart: its ``conv='pallas'`` export bakes the Mosaic kernel into the
StableHLO itself.

Each operator has a CUDA implementation, which calls the existing launcher
(``sepconv._launch``, ``logmel._launch_operands``) and counts the launch on
the wrapper's ``launches`` (``sepconv._count_launch``), and a fake
implementation, which gives the output's shape and dtype for tracing. None
has a CPU implementation: on the CPU the wrappers compute their plain
versions (``sepconv._route``), and an operator called on CPU tensors
raises ``NotImplementedError``.

An operator takes only tensors, lists of tensors and scalars, so the
packed conv operands travel as one flat ``Tensor[]`` (four per layer, in
``sepconv._check``'s order: depthwise taps, depthwise bias, the mode's
pointwise operand, pointwise bias), the layer range as ints and the mode
as a string; the log-mel's constants (``logmel._operands``: the DFT in bin
chunks, bin 256, the mel matrix) as a ``Tensor[]``, with the frame
geometry as ints and ``log_offset`` as a float.
"""

import torch
from torch import Tensor

from buzzdetect_torch.ops import logmel, sepconv

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


@torch.library.custom_op(f'{NAMESPACE}::fused_front', mutates_args=(),
                         device_types='cuda')
def fused_front(x: Tensor, operands: list[Tensor], start_layer: int,
                stop_layer: int, mode: str) -> Tensor:
    """Layers [start_layer, stop_layer) of the separable-conv stack on
    (B, H, W, C) NHWC f32 -> (B, Ho*Wo, F) in ``mode``."""
    specs = sepconv.tail_specs(start_layer, stop_layer)
    out = sepconv._launch(_layers(operands, specs), x, specs, False, mode)
    sepconv._count_launch(sepconv.fused_front, mode,
                          (start_layer, stop_layer), x.shape[0])
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
    out = sepconv._launch(_layers(operands, specs), x, specs, gap, mode)
    sepconv._count_launch(sepconv.fused_tail, mode,
                          (start_layer, stop_layer), x.shape[0])
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
            hop: int, log_offset: float) -> Tensor:
    """(B, n) contiguous f32 waveforms -> (B, n_frames, 64) log-mel;
    ``constants`` is ``[chunks, nyq, mel]`` of ``logmel._operands``."""
    _log_mel_frames(waveform.shape[-1], window, hop)
    chunks, nyq, mel = constants
    out = logmel._launch_operands(waveform, chunks, nyq, mel, log_offset)
    sepconv._count_launch(logmel.log_mel_spectrogram_fused)
    return out


@log_mel.register_fake
def _(waveform, constants, window, hop, log_offset):
    n_frames = _log_mel_frames(waveform.shape[-1], window, hop)
    return waveform.new_empty((waveform.shape[0], n_frames, logmel.MELS))
