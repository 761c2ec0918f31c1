"""Probe: do int8 pointwise convs beat bf16 on the card?

Counterpart of ``tools/int8_tpu_probe.py``. YAMNet's 13 pointwise (1x1)
convs carry ~74% of the MACs and are pure matmuls, so they are the only
part of the graph that can ride the tensor cores' int8 mode (H100 SXM:
1979 TOPS dense int8 against 989 TFLOP/s bf16, a 2x ceiling). The probe
builds a prototype embed (``embed_q8``) with

  * the stem 3x3 conv and every depthwise conv in bf16 through cuDNN
    (``F.conv2d`` on bf16 tensors), as the JAX probe runs them through
    XLA, and
  * the pointwise convs as int8 x int8 -> int32 products,
    ``torch._int_mm`` on the flattened (B*H*W, Cin) activations (the JAX
    probe's XLA ``dot_general``): symmetric per-output-channel weight
    scales computed offline (``quantize_pointwise``), and a per-tensor
    activation scale, dynamic (abs-max on the device, each layer) or
    static (``calibrate_act_scales``, one f32 forward pass),

and times it against the port's shipped f32 and bf16 embeds (on the card
the hand-written conv kernels of ``csrc/sepconv.cu``), with each one's
embedding deviation from f32, so the parity cost is recorded next to the
time. Edits: CUDA events (``utils.cuda_time_ms``) and device time
(``utils.cuda_device_ms``) in place of the dispatch slope (the CPU run,
``--device cpu``, times by the host clock); each row's bound from the
H100 SXM data sheet; the functions are importable.

``torch._int_mm`` on CUDA needs more than 16 rows and K, N multiples of 8.
Every pointwise K and N of YAMNet is a multiple of 8, and the last layers
have 3 x 2 positions a patch, so ``--patches`` must be at least 3; the
probe refuses a smaller batch rather than run another product.

    python -m buzzdetect_torch.tools.int8_probe [--patches 1000]
        [--chunks 20] [--device cpu]
"""

import argparse
import os
import statistics
import time

import numpy as np

# H100 SXM data sheet, dense: int8 tensor cores, bf16 tensor cores, f32
# outside the tensor cores, HBM bytes/s
INT8_PEAK, BF16_PEAK, F32_PEAK, BYTES_PEAK = 1979e12, 989e12, 67e12, 3.35e12
# torch._int_mm on CUDA: rows > 16
MIN_ROWS = 17


def _is_pointwise(key: str) -> bool:
    return key.endswith('/pointwise_conv')


def quantize_pointwise(params: dict) -> dict:
    """Folded HWIO numpy params -> the probe's: for each pointwise conv an
    int8 ``qkernel`` (Cin, Cout) and its f32 per-output-channel ``wscale``
    (max |w| / 127, 1 where a column is 0), the JAX tool's formula; every
    other conv keeps its ``kernel``; every conv keeps its ``bias``."""
    from buzzdetect_torch.models import yamnet as yamnet_lib
    qparams = {}
    for key, _kind, _stride, _shape in yamnet_lib._conv_shapes():
        kernel = params[f'{key}/kernel']
        if _is_pointwise(key):
            w = kernel.reshape(kernel.shape[2], kernel.shape[3])
            s_w = np.max(np.abs(w), axis=0) / 127.0
            s_w = np.where(s_w == 0, 1.0, s_w)
            qparams[f'{key}/qkernel'] = np.clip(
                np.round(w / s_w), -127, 127).astype(np.int8)
            qparams[f'{key}/wscale'] = s_w.astype(np.float32)
        else:
            qparams[f'{key}/kernel'] = kernel
        qparams[f'{key}/bias'] = params[f'{key}/bias']
    return qparams


def to_device(qparams: dict, device) -> dict:
    """``quantize_pointwise``'s arrays as tensors on ``device``: int8
    ``qkernel`` (Cin, Cout) laid out column-major (the transpose of a
    contiguous (Cout, Cin), the operand layout cuBLASLt's int8 product
    takes), f32 ``wscale`` and ``bias``, and the other kernels in
    ``F.conv2d``'s OIHW layout in bf16."""
    import torch
    out = {}
    for k, v in qparams.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if k.endswith('/kernel'):
            t = t.permute(3, 2, 0, 1).contiguous().to(torch.bfloat16)
        elif k.endswith('/qkernel'):
            t = t.t().contiguous().t()
        out[k] = t.to(device)
    return out


def check_rows(n_patches: int):
    """Refuse a batch whose smallest pointwise product has too few rows for
    ``torch._int_mm`` on CUDA."""
    from buzzdetect_torch.models import yamnet as yamnet_lib
    h, w, rows = 96, 64, []
    for key, _kind, stride, _shape in yamnet_lib._conv_shapes():
        h, w = -(-h // stride), -(-w // stride)
        if _is_pointwise(key):
            rows.append(n_patches * h * w)
    if min(rows) < MIN_ROWS:
        raise ValueError(f'{n_patches} patches give a pointwise product of '
                         f'{min(rows)} rows; torch._int_mm on CUDA needs '
                         f'at least {MIN_ROWS}: pass --patches >= '
                         f'{-(-MIN_ROWS // (min(rows) // n_patches))}')


def embed_q8(qparams: dict, patches, act_scales=None):
    """(B, 96, 64) log-mel patches -> (B, 1024) f32 embeddings through the
    int8 prototype: activations in bf16; the stem and depthwise convs in
    bf16 (``F.conv2d``, TF-SAME padding); each pointwise conv quantizes its
    input with a per-tensor scale, ``act_scales[key]`` (static) or
    max |x| / 127 on the device (dynamic, ``act_scales`` None), multiplies
    it by the int8 kernel with ``torch._int_mm`` (int32) and rescales by
    the activation and weight scales; then bias, ReLU and a round to bf16;
    global average pooling in f32. ``qparams`` from ``to_device``."""
    import torch
    from buzzdetect_torch.models import yamnet as yamnet_lib
    x = patches.to(torch.bfloat16)
    if x.dim() == 4:
        x = x[..., 0]
    x = x[:, None]                                   # (B, 1, 96, 64)
    for key, kind, stride, _shape in yamnet_lib._conv_shapes():
        bias = qparams[f'{key}/bias'][:, None, None]
        if _is_pointwise(key):
            b, cin, h, w = x.shape
            if act_scales is None:
                amax = x.abs().max().to(torch.float32)
                s_a = torch.clamp(amax, min=1e-12) / 127.0
            else:
                s_a = act_scales[key]
            qx = torch.clamp(torch.round(x.to(torch.float32) / s_a),
                             -127, 127).to(torch.int8)
            rows = qx.permute(0, 2, 3, 1).reshape(b * h * w, cin)
            y = torch._int_mm(rows, qparams[f'{key}/qkernel'])
            y = (y.to(torch.float32) * (s_a * qparams[f'{key}/wscale']))
            y = y.reshape(b, h, w, -1).permute(0, 3, 1, 2)
        else:
            groups = x.shape[1] if kind == 'depthwise' else 1
            y = yamnet_lib._conv_same(x, qparams[f'{key}/kernel'], stride,
                                      groups)
        x = torch.relu(y.to(torch.float32) + bias).to(torch.bfloat16)
    return x.to(torch.float32).mean(dim=(2, 3))


def calibrate_act_scales(params: dict, patches) -> dict:
    """Per-layer input abs-max / 127 of every pointwise conv from one f32
    forward pass of the folded HWIO numpy ``params`` (exact f32, TF32 off)
    on ``patches``' device: ``{key: float}``."""
    import torch
    from buzzdetect_torch.models import yamnet as yamnet_lib
    from buzzdetect_torch.ops.common import exact_f32
    exact_f32()
    x = patches.to(torch.float32)
    if x.dim() == 4:
        x = x[..., 0]
    x = x[:, None]
    scales = {}
    with torch.no_grad():
        for key, kind, stride, _shape in yamnet_lib._conv_shapes():
            if _is_pointwise(key):
                scales[key] = float(x.abs().max()) / 127.0
            kernel = torch.from_numpy(np.ascontiguousarray(
                params[f'{key}/kernel'].transpose(3, 2, 0, 1))).to(x.device)
            bias = torch.from_numpy(params[f'{key}/bias']).to(x.device)
            groups = x.shape[1] if kind == 'depthwise' else 1
            x = torch.relu(yamnet_lib._conv_same(x, kernel, stride, groups)
                           + bias[:, None, None])
    return scales


def embed_ops(n_patches: int):
    """(pointwise, other) operations of one embed of ``n_patches``: each
    conv's multiply-adds counted twice."""
    from buzzdetect_torch.models import yamnet as yamnet_lib
    h, w, pw, other = 96, 64, 0, 0
    for key, kind, stride, shape in yamnet_lib._conv_shapes():
        h, w = -(-h // stride), -(-w // stride)
        fan = shape[0] * shape[1] * (1 if kind == 'depthwise' else shape[2])
        ops = 2 * h * w * fan * shape[3] * n_patches
        if _is_pointwise(key):
            pw += ops
        else:
            other += ops
    return pw, other


def bounds_ms(n_patches: int) -> dict:
    """Each row's least time on an H100 SXM (data sheet, dense), the larger
    of its operations over the peaks of the units that run them (the f32
    kernels on FFMA; bf16 and int8 pointwise products on the tensor cores,
    the other convs outside them) and its bytes (the f32 patches read, the
    f32 embeddings written) over the memory rate; with what bounds it."""
    pw, other = embed_ops(n_patches)
    t_bytes = 4 * n_patches * (96 * 64 + 1024) / BYTES_PEAK
    t_ops = {'f32': (pw + other) / F32_PEAK,
             'bf16': max(pw / BF16_PEAK, other / F32_PEAK)}
    t_ops['int8-dynamic'] = t_ops['int8-static'] = max(pw / INT8_PEAK,
                                                        other / F32_PEAK)
    return {k: (1e3 * max(t, t_bytes),
                'operations' if t >= t_bytes else 'bytes')
            for k, t in t_ops.items()}


def _host_ms(fn, reps):
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def run(n_patches: int = 1000, chunks: int = 20, device='cuda',
        arrays=None, log=print) -> dict:
    """The probe: the four embeds on ``n_patches`` seeded log-mel-like
    patches (normal, x 1.5 - 1, as the JAX probe draws them) of
    ``arrays`` (folded or raw bundle arrays; model_general_v3's by
    default), each's max |embedding - f32| (int8-static on a held-out
    batch, as the JAX probe holds it) and median time over ``chunks``
    calls. Returns ``{row: {'dev', 'ms', 'device_ms', 'bound_ms',
    'bound_by'}}`` plus ``'scale'``, the f32 embeddings' abs-max."""
    import torch
    from buzzdetect_torch.models import yamnet as yamnet_lib
    from buzzdetect_torch.models.classifier import resolve_device
    from buzzdetect_torch.models.convert import load_bundle
    from buzzdetect_torch.models.weights import params_from_numpy
    from buzzdetect_torch.ops import sepconv
    from buzzdetect_torch.ops.common import exact_f32
    from buzzdetect_torch.utils import cuda_device_ms, cuda_time_ms

    check_rows(n_patches)
    dev = resolve_device(device)
    if arrays is None:
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        arrays, _config = load_bundle(os.path.join(repo, 'models',
                                                   'model_general_v3'))
    raw = {k[len('yamnet_raw/'):]: np.asarray(v) for k, v in arrays.items()
           if k.startswith('yamnet_raw/')}
    params = (yamnet_lib.fold_batchnorm(raw) if raw else
              {k[len('yamnet/'):]: np.asarray(v) for k, v in arrays.items()
               if k.startswith('yamnet/')})
    exact_f32()
    if dev.type == 'cuda':
        sepconv.load_kernels()
    shipped = params_from_numpy({f'yamnet/{k}': v for k, v in params.items()},
                                dev)['yamnet']
    packed = {m: sepconv.pack_params(shipped, m) for m in ('highest', 'bf16')}
    qparams = to_device(quantize_pointwise(params), dev)

    gen = torch.Generator(device=dev).manual_seed(0)
    pats = [torch.randn((n_patches, 96, 64), generator=gen, device=dev)
            * 1.5 - 1.0 for _ in range(2)]
    scales = calibrate_act_scales(params, pats[0])
    embeds = {
        'f32': lambda p: yamnet_lib.embed(packed['highest'], p),
        'bf16': lambda p: yamnet_lib.embed(packed['bf16'], p,
                                           torch.bfloat16),
        'int8-dynamic': lambda p: embed_q8(qparams, p),
        'int8-static': lambda p: embed_q8(qparams, p, scales)}
    bounds = bounds_ms(n_patches)
    out = {}
    with torch.inference_mode():
        ref = [embeds['f32'](p) for p in pats]
        out['scale'] = float(ref[0].abs().max())
        for name, fn in embeds.items():
            i = 1 if name == 'int8-static' else 0
            row = {'dev': float((fn(pats[i]) - ref[i]).abs().max())}
            if dev.type == 'cuda':
                row['ms'] = cuda_time_ms(lambda: fn(pats[0]), reps=chunks)
                row['device_ms'] = cuda_device_ms(lambda: fn(pats[0]),
                                                  reps=chunks)
            else:
                row['ms'] = _host_ms(lambda: fn(pats[0]), chunks)
            row['bound_ms'], row['bound_by'] = bounds[name]
            out[name] = row
    where = (f'{dev} ({torch.cuda.get_device_name(dev)})'
             if dev.type == 'cuda' else 'the CPU (host clock)')
    log(f'embedding abs-max (f32 ref): {out["scale"]:.4f}')
    log(f'max |bf16 - f32|: {out["bf16"]["dev"]:.5f}   max |int8-dyn - f32|: '
        f'{out["int8-dynamic"]["dev"]:.5f}   max |int8-static - f32| '
        f'(held-out batch): {out["int8-static"]["dev"]:.5f}')
    log(f'{n_patches} patches/call on {where}, median of {chunks} calls; '
        f'bound from the H100 SXM data sheet (int8 1979 TOPS, bf16 989 '
        f'TFLOP/s, f32 67 TFLOP/s outside the tensor cores, 3.35 TB/s):')
    for name in embeds:
        r = out[name]
        device_ms = (f', device {r["device_ms"]:.4f} ms'
                     if 'device_ms' in r else '')
        log(f'  embed {name:13s} {r["ms"]:9.4f} ms{device_ms}; bound '
            f'{r["bound_ms"]:.4f} ms ({r["bound_by"]})')
    key = 'device_ms' if dev.type == 'cuda' else 'ms'
    for name in ('int8-dynamic', 'int8-static'):
        log(f'embed {name} vs bf16: '
            f'{out["bf16"][key] / out[name][key]:.2f}x   vs f32: '
            f'{out["f32"][key] / out[name][key]:.2f}x'
            + (' (device time)' if key == 'device_ms' else ''))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--patches', type=int, default=1000,
                    help='batch of 96x64 log-mel patches (1000 ~= 960 s)')
    ap.add_argument('--chunks', type=int, default=20,
                    help='timed calls per row (the median is printed)')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    args = ap.parse_args(argv)
    return run(args.patches, args.chunks, args.device)


if __name__ == '__main__':
    main()
