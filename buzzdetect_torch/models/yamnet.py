"""YAMNet (MobileNet-v1 audio embedder) in PyTorch.

Counterpart of ``buzzdetect_tpu/models/yamnet.py`` (architecture parity with
the published YAMNet, reference `embedders/yamnet/yamnet.py:77-106`): a 3x3
stride-2 full conv to 32 channels, then 13 depthwise-separable blocks up to
1024 channels, each conv followed by BatchNorm (center only, eps 1e-4) and
ReLU, ending in global average pooling to a 1024-d embedding per patch.

Inference runs on BatchNorm-folded weights, along one of two paths:

* the kernels (``embed``, the JAX package's ``conv='pallas'``): layer 1 is
  a plain ``F.conv2d`` (the JAX package leaves it to XLA); layers 2-7 and
  8-14 + pooling go through the hand-written kernels in ``ops/sepconv.py``,
  in the mode that ``compute_dtype`` and ``conv_precision`` select
  (``conv_mxu_precision``, copied from ``buzzdetect_tpu/models/yamnet.py``,
  then ``sepconv.resolve_mode``);
* the XLA conv path (``embed_xla``, the JAX package's ``conv='xla'``):
  every one of the 27 convs is a library ``F.conv2d`` (cuDNN on the card,
  TF32 off), with no kernel of its own, as the JAX package runs it outside
  any Pallas kernel.
"""

import numpy as np
import torch
import torch.nn.functional as F

from buzzdetect_torch.ops.sepconv import (
    exact_f32, fused_front, fused_tail, resolve_compute_dtype, resolve_mode,
    round_bf16, same_pad, tail_specs)

# (kind, stride, output_filters); every kernel is 3x3.
LAYER_DEFS = (
    ('conv', 2, 32),
    ('sep', 1, 64),
    ('sep', 2, 128),
    ('sep', 1, 128),
    ('sep', 2, 256),
    ('sep', 1, 256),
    ('sep', 2, 512),
    ('sep', 1, 512),
    ('sep', 1, 512),
    ('sep', 1, 512),
    ('sep', 1, 512),
    ('sep', 1, 512),
    ('sep', 2, 1024),
    ('sep', 1, 1024),
)

N_EMBEDDINGS = 1024
BN_EPSILON = 1e-4
# the kernels' split of the stack: fused_front runs [2, TAIL_START),
# fused_tail runs [TAIL_START, end) and pools
TAIL_START = 8


# --- parameter construction --------------------------------------------------

def _conv_shapes():
    """Yield (name, kind, stride, kernel_shape) for every conv in the net.

    Kernel shapes are HWIO; depthwise kernels are (3, 3, 1, C).
    """
    in_ch = 1
    for i, (kind, stride, filters) in enumerate(LAYER_DEFS):
        name = f'layer{i + 1}'
        if kind == 'conv':
            yield f'{name}/conv', 'full', stride, (3, 3, in_ch, filters)
        else:
            yield f'{name}/depthwise_conv', 'depthwise', stride, (3, 3, 1, in_ch)
            yield f'{name}/pointwise_conv', 'full', 1, (1, 1, in_ch, filters)
        in_ch = filters


def init_raw_params(seed: int = 0):
    """Deterministic raw (unfolded) parameters: truncated-normal kernels,
    fresh BatchNorm statistics (numpy, HWIO)."""
    rng = np.random.default_rng(seed)
    params = {}
    for key, kind, _stride, shape in _conv_shapes():
        fan_in = shape[0] * shape[1] * (shape[2] if kind == 'full' else 1)
        std = float(np.sqrt(2.0 / fan_in))
        k = rng.standard_normal(shape).astype(np.float32) * std
        np.clip(k, -2 * std, 2 * std, out=k)
        ch = shape[3]
        params[f'{key}/kernel'] = k
        params[f'{key}/bn_beta'] = np.zeros(ch, np.float32)
        params[f'{key}/bn_mean'] = np.zeros(ch, np.float32)
        params[f'{key}/bn_var'] = np.ones(ch, np.float32)
    return params


def fold_batchnorm(raw: dict) -> dict:
    """Fold BatchNorm (center only, no scale) into conv kernel + bias:

        y = (conv(x) - mean) / sqrt(var + eps) + beta
          = conv(x) * s + (beta - mean * s),   s = 1/sqrt(var + eps)

    Returns numpy {conv/kernel, conv/bias} in HWIO.
    """
    folded = {}
    for key, _kind, _stride, _shape in _conv_shapes():
        kernel = np.asarray(raw[f'{key}/kernel'], np.float32)
        beta = np.asarray(raw[f'{key}/bn_beta'], np.float32)
        mean = np.asarray(raw[f'{key}/bn_mean'], np.float32)
        var = np.asarray(raw[f'{key}/bn_var'], np.float32)
        scale = 1.0 / np.sqrt(var + BN_EPSILON)
        folded[f'{key}/kernel'] = kernel * scale  # broadcast over last axis
        folded[f'{key}/bias'] = beta - mean * scale
    return folded


# --- forward pass -------------------------------------------------------------

def conv_mxu_precision(compute_dtype, conv_precision: str) -> str:
    """Precision of the conv stack's products, from the product knob, as
    ``buzzdetect_tpu.models.yamnet.conv_mxu_precision`` resolves it (the
    names of ``jax.lax.Precision`` in lower case).

    f32 operands: ``'highest'`` is exact f32 (the oracle and the kernels'
    default), ``'high'`` the 3-product bf16 hi/lo split. bf16 compute always
    runs ``'default'``: one bf16 product, the operands are already bf16.
    """
    # validate BEFORE the dtype short-circuit: a typo'd knob must fail
    # loudly on the bf16 path too, not only when f32 happens to run
    if conv_precision not in ('high', 'highest'):
        raise ValueError(
            f"conv_precision must be 'high' or 'highest', "
            f"got {conv_precision!r}")
    if resolve_compute_dtype(compute_dtype) != torch.float32:
        return 'default'
    return conv_precision


def layer1(params: dict, patches: torch.Tensor,
           mode: str = 'highest') -> torch.Tensor:
    """(B, 96, 64[, 1]) patches -> (B, 48, 32, 32) NHWC layer-1 activations:
    full 3x3 stride-2 conv with TF-SAME padding (bottom/right only), bias,
    ReLU.

    ``mode`` is the conv kernels' mode. In ``'bf16'`` the patches and the
    kernel are rounded to bf16, the products accumulate in f32, bias and
    ReLU run in f32, and the output is rounded to bf16 (held in f32), as the
    JAX package's ``packed_l1`` computes under bf16 compute. Otherwise
    (``'highest'``, and ``'high'`` too) the layer is exact f32: for HIGH,
    exact f32 is what XLA computes on the CPU oracle, and cuDNN has no
    3-product bf16 convolution."""
    exact_f32()
    x = patches.to(torch.float32)
    if x.dim() == 4:
        x = x[..., 0]
    kernel = params['layer1/conv/kernel']
    if mode == 'bf16':
        x, kernel = round_bf16(x), round_bf16(kernel)
    ph, pw = same_pad(x.shape[1], 2), same_pad(x.shape[2], 2)
    x = F.pad(x[:, None], (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(x, kernel, stride=2)
    y = torch.relu(y + params['layer1/conv/bias'][:, None, None])
    if mode == 'bf16':
        y = round_bf16(y)
    return y.permute(0, 2, 3, 1).contiguous()


def embed(params: dict, patches: torch.Tensor, compute_dtype=torch.float32,
          conv_precision: str = 'highest', conv: str = 'pallas'
          ) -> torch.Tensor:
    """Log-mel patches (B, 96, 64) or (B, 96, 64, 1) -> (B, 1024) embeddings
    (pre-head, post-pooling), f32.

    ``conv='xla'`` runs ``embed_xla`` (``params`` packed by ``pack_xla``).
    ``conv='pallas'`` runs the kernels: ``params`` is the ``yamnet`` dict of
    ``models/weights.params_from_numpy``, with ``sepconv.pack_params``
    applied for the mode (the f32 'highest' mode needs nothing packed);
    ``compute_dtype`` and ``conv_precision`` select the kernels' mode, as in
    the JAX package's ``embed(..., conv='pallas')``.
    """
    if conv == 'xla':
        return embed_xla(params, patches, compute_dtype, conv_precision)
    if conv != 'pallas':
        raise ValueError(f"conv must be 'xla' or 'pallas', got {conv!r}")
    mode = resolve_mode(compute_dtype,
                        conv_mxu_precision(compute_dtype, conv_precision))
    x = layer1(params, patches, mode)
    y = fused_front(params, x, start_layer=2, stop_layer=TAIL_START,
                    mode=mode)
    s = tail_specs(2, TAIL_START)[-1]
    y = y.reshape(y.shape[0], s.h_out, s.w_out, s.c_out)
    return fused_tail(params, y, start_layer=TAIL_START, gap=True, mode=mode)


# --- the XLA conv path ----------------------------------------------------------

def _xla_key(key: str, compute_dtype) -> str:
    bf16 = resolve_compute_dtype(compute_dtype) == torch.bfloat16
    return f'{key}/kernel[xla-bf16]' if bf16 else f'{key}/kernel[xla]'


def pack_xla(params: dict, compute_dtype=torch.float32) -> dict:
    """``params`` plus every conv's kernel in ``F.conv2d``'s OIHW layout for
    ``embed_xla`` (a new dict; the tensors already there are shared):
    layer 1 as it is, a depthwise (9, C) as (C, 1, 3, 3), a pointwise
    (C, F) as (F, C, 1, 1); under bf16 compute each rounded to bf16 (held
    in f32), as the JAX package casts the kernels to the compute dtype."""
    bf16 = resolve_compute_dtype(compute_dtype) == torch.bfloat16
    out = dict(params)
    for key, kind, _stride, shape in _conv_shapes():
        k = params[f'{key}/kernel']
        if kind == 'depthwise':
            k = k.t().reshape(shape[3], 1, 3, 3)
        elif shape[0] == 1:
            k = k.t().reshape(shape[3], shape[2], 1, 1)
        k = k.contiguous()
        out[_xla_key(key, compute_dtype)] = round_bf16(k) if bf16 else k
    return out


def _conv_same(x: torch.Tensor, kernel: torch.Tensor, stride: int,
               groups: int) -> torch.Tensor:
    """NCHW ``x`` convolved with OIHW ``kernel`` under TF-SAME padding: a
    symmetric pad rides the convolution, an asymmetric one (stride 2:
    bottom/right only) is a pad ahead of it."""
    k = kernel.shape[-1]
    ph = same_pad(x.shape[2], stride, k)
    pw = same_pad(x.shape[3], stride, k)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, kernel, stride=stride, padding=(ph[0], pw[0]),
                        groups=groups)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, kernel, stride=stride, groups=groups)


def embed_xla(params: dict, patches: torch.Tensor,
              compute_dtype=torch.float32, conv_precision: str = 'highest'
              ) -> torch.Tensor:
    """Log-mel patches (B, 96, 64) or (B, 96, 64, 1) -> (B, 1024) f32
    embeddings through the XLA conv path: the counterpart of
    ``buzzdetect_tpu.models.yamnet.embed(..., conv='xla')``.

    All 27 convs of ``_conv_shapes()`` in order, each an ``F.conv2d`` with
    TF-SAME padding (``groups=C`` for a depthwise one), then the bias in
    f32, ReLU, and the result rounded to the compute dtype; global average
    pooling in f32 at the end. ``params`` is packed by ``pack_xla`` for
    ``compute_dtype``.

    Under bf16 compute the patches, the kernels and every layer's output
    are rounded to bf16, and each convolution runs in f32 (TF32 off): a
    product of two bf16 values is exact in f32, so this computes what the
    JAX package's bf16 operands with ``preferred_element_type=float32``
    compute, up to the order of the sums. ``F.conv2d`` on bf16 tensors
    would round each output to bf16 before the bias, a different function.
    It costs about what the f32 path costs.

    ``conv_precision`` is validated but selects nothing: ``'high'`` and
    ``'highest'`` both run exact f32. The TPU's ``'high'`` is a three-pass
    bf16 product; cuDNN has none, and TF32 (one reduced pass) is refused
    for f32. Exact f32 is also what XLA computes for both on the CPU.
    """
    conv_mxu_precision(compute_dtype, conv_precision)
    bf16 = resolve_compute_dtype(compute_dtype) == torch.bfloat16
    exact_f32()
    x = patches.to(torch.float32)
    if x.dim() == 4:
        x = x[..., 0]
    x = x[:, None]                                      # (B, 1, 96, 64)
    if bf16:
        x = round_bf16(x)
    for key, kind, stride, _shape in _conv_shapes():
        groups = x.shape[1] if kind == 'depthwise' else 1
        y = _conv_same(x, params[_xla_key(key, compute_dtype)], stride,
                       groups)
        x = torch.relu(y + params[f'{key}/bias'][:, None, None])
        if bf16:
            x = round_bf16(x)
    return x.mean(dim=(2, 3))


# --- training ---------------------------------------------------------------------

def embed_train(raw_params: dict, patches: torch.Tensor, *,
                momentum: float = 0.99):
    """Training-mode forward pass with live BatchNorm: the counterpart of
    ``buzzdetect_tpu.models.yamnet.embed_train``.

    ``raw_params`` holds the raw (unfolded) parameters as tensors in the
    JAX package's layout (HWIO kernels, per-channel ``bn_*``): the kernels
    and ``bn_beta`` may require grad, ``bn_mean`` and ``bn_var`` are state.
    Each conv is ``_conv_same`` (TF-SAME padding; the kernel permuted to
    OIHW inside the graph, so gradients come back in HWIO); BatchNorm takes
    the batch mean and biased variance over (N, H, W), has no scale, and
    is followed by ReLU. ``F.batch_norm`` is not used: its running variance
    is the unbiased one and its momentum weights the batch, not the old
    value.

    Returns ``(embeddings (B, 1024), new_stats)``, ``new_stats`` holding
    every layer's ``bn_mean`` and ``bn_var`` as ``momentum * old + (1 -
    momentum) * batch``, detached from the graph.
    """
    x = patches.to(torch.float32)
    if x.dim() == 4:
        x = x[..., 0]
    x = x[:, None]                                      # (B, 1, 96, 64)
    new_stats = {}
    for key, kind, stride, _shape in _conv_shapes():
        kernel = raw_params[f'{key}/kernel'].permute(3, 2, 0, 1)
        groups = x.shape[1] if kind == 'depthwise' else 1
        x = _conv_same(x, kernel, stride, groups)
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), correction=0)
        beta = raw_params[f'{key}/bn_beta']
        x = ((x - mean[:, None, None]) * torch.rsqrt(var + BN_EPSILON)[
            :, None, None] + beta[:, None, None])
        x = torch.relu(x)
        with torch.no_grad():
            for stat, batch in (('bn_mean', mean), ('bn_var', var)):
                new_stats[f'{key}/{stat}'] = (
                    momentum * raw_params[f'{key}/{stat}']
                    + (1 - momentum) * batch)
    return x.mean(dim=(2, 3)), new_stats
