"""Speed-of-light accounting for the classify graph on one NVIDIA H100.

Counterpart of ``tools/roofline.py``. For every stage of the graph (DFT,
mel, each conv layer, pooling, head) this prints the analytical FLOP count
and the least device-memory traffic per chunk, and the resulting roofline
lower bound on time: whichever of the stage's engine or the memory binds.
``--measure`` replaces the data-sheet peaks with ones measured on the card,
and ``--layers`` adds measured per-layer times.

Engines. A stage is a matrix product (``matmul``: the DFT and mel
products, layer 1, the pointwise convolutions, the head) or vector work
(``vector``: depthwise convolutions, pooling, patch framing). In f32 the
port keeps TF32 off, so both run on the f32 pipes outside the tensor cores
and share the f32 peak; with ``--bf16`` the matrix products are bound by the
tensor cores' dense bf16 peak. The peaks are NVIDIA's data-sheet values for
the card ``nvidia-smi`` names (``PEAKS``, the one peak table of the port).
``--measure`` times, with CUDA events, an f32 ``torch.matmul`` with TF32
off (a bf16 one with ``--bf16``), the FMA chain kernel of ``csrc/probe.cu``
(``ops/probe.fma_chain``) and a 1 GiB streaming copy. ``--layers`` measures
conv layers as prefix differences of the plain layer stack in cuDNN (TF32
off): prefix k runs layer 1 (``models/yamnet.layer1``) and separable layers
2..k (``F.conv2d`` for both convolutions); layer k's time is prefix(k) -
prefix(k-1).

``graph_stages`` is copied from ``tools/roofline.py:52-108`` and
``lower_bound`` from ``:111-116`` (code that needs no JAX), on the port's
``LAYER_DEFS`` and ``FrontendConfig``, with the engines renamed.

Usage:
    python -m buzzdetect_torch.tools.roofline                # the card's table
    python -m buzzdetect_torch.tools.roofline --device cpu   # H100 SXM sheet
    python -m buzzdetect_torch.tools.roofline --seconds 200.64 --measure
    python -m buzzdetect_torch.tools.roofline --measure --layers 2,3,13,14
"""

import argparse
import math
import os
import sys

# NVIDIA's data-sheet peaks, dense (no sparsity), at the full power limit:
# (f32 FLOP/s outside the tensor cores, bf16 tensor-core FLOP/s,
#  device-memory bytes/s)
PEAKS = {'H100 SXM': (67e12, 989e12, 3.35e12),
         'H100 PCIe': (51.2e12, 756e12, 2.0e12)}
# the FMA chain --measure times: elements and steps (0.5 ms on an H100), and
# its map v -> a v + b, a contraction towards the fixed point b / (1 - a) = 1:
# 1024 steps scale v - 1 by a**1024 = 0.36, so a chain that skips or repeats
# steps lands far from the plain version (the JAX tool's a = 1.000001 moved
# each value by 1e-3 relative, close to its rounding)
FMA_ELEMENTS, FMA_STEPS = 1 << 24, 1024
FMA_A, FMA_B = 0.999, 0.001


def peaks(name: str):
    """(f32, bf16 tensor-core, bytes/s) peaks of the card ``name``, as
    ``nvidia-smi`` or ``torch.cuda.get_device_name`` give it."""
    if 'H100' not in name:
        raise ValueError(f'no peak table for {name!r} (known: '
                         f'{", ".join(PEAKS)})')
    return PEAKS['H100 PCIe' if 'PCIe' in name else 'H100 SXM']


def conv_out(h, w, stride):
    return math.ceil(h / stride), math.ceil(w / stride)


def graph_stages(seconds=960.0, n_classes=13, dtype_bytes=4):
    """Yield (name, engine, flops, bytes) per chunk of ``seconds``.

    Bytes are the *minimum* traffic for an unfused graph: each stage reads
    its input once from device memory and writes its output once (weights
    are counted but negligible at 1000-patch batches). A fused kernel's
    floor is lower: only the stage boundary arrays it materializes.
    """
    from buzzdetect_torch.models.yamnet import LAYER_DEFS
    from buzzdetect_torch.ops.frontend import FrontendConfig

    cfg = FrontendConfig()
    n_samples = int(seconds * cfg.sample_rate)
    n_frames = n_samples // cfg.hop_samples
    b = int(seconds / cfg.patch_window_seconds)      # patches at framehop 1.0

    win, bins, mel = cfg.window_samples, cfg.fft_bins, cfg.mel_bands

    # DFT as two banked matmuls (re+im): (frames, 400) @ (400, 257) x 2
    yield ('dft (banked matmuls)', 'matmul',
           2 * n_frames * win * bins * 2,
           (n_samples + n_frames * bins) * dtype_bytes
           + 2 * win * bins * dtype_bytes)
    # magnitude + mel projection + log: (frames, 257) @ (257, 64)
    yield ('mel + log', 'matmul',
           2 * n_frames * bins * mel + 4 * n_frames * bins,
           (n_frames * bins + n_frames * mel) * dtype_bytes)
    # patch framing is a reshape/slice: traffic only
    yield ('patch framing', 'vector', 0,
           2 * b * cfg.patch_frames * mel * dtype_bytes)

    h, w, c = cfg.patch_frames, mel, 1
    for i, (kind, stride, filters) in enumerate(LAYER_DEFS):
        name = f'layer{i + 1}'
        ho, wo = conv_out(h, w, stride)
        if kind == 'conv':
            yield (f'{name} conv 3x3/{stride} {c}->{filters}', 'matmul',
                   2 * b * ho * wo * filters * 9 * c,
                   (b * h * w * c + b * ho * wo * filters + 9 * c * filters)
                   * dtype_bytes)
        else:
            yield (f'{name} dw 3x3/{stride} @{c}', 'vector',
                   2 * b * ho * wo * c * 9,
                   (b * h * w * c + b * ho * wo * c + 9 * c) * dtype_bytes)
            yield (f'{name} pw 1x1 {c}->{filters}', 'matmul',
                   2 * b * ho * wo * c * filters,
                   (b * ho * wo * c + b * ho * wo * filters + c * filters)
                   * dtype_bytes)
        h, w, c = ho, wo, filters

    yield ('global avg pool', 'vector', b * h * w * c,
           (b * h * w * c + b * c) * dtype_bytes)
    yield ('head 1024->classes', 'matmul', 2 * b * c * n_classes,
           (b * c + b * n_classes + c * n_classes) * dtype_bytes)


def lower_bound(flops, nbytes, engine, matmul_peak, vector_peak, bw):
    """(seconds, what binds: 'BW', 'MATMUL' or 'VECTOR')."""
    t_compute = flops / (matmul_peak if engine == 'matmul' else vector_peak)
    t_bw = nbytes / bw
    t = max(t_compute, t_bw)
    bound = ('BW' if t_bw >= t_compute else engine.upper())
    return t, bound


# --- the cuDNN layer stack ---------------------------------------------------

def library_weights(params, specs, dtype):
    """Per layer (depthwise OIHW, its bias, pointwise OIHW, its bias), in
    the layout and type cuDNN takes; built once, outside a timed region."""
    return [tuple(t.to(dtype) for t in (
        params[f'{s.name}/depthwise_conv/kernel'].t().reshape(
            s.c_in, 1, 3, 3).contiguous(),
        params[f'{s.name}/depthwise_conv/bias'],
        params[f'{s.name}/pointwise_conv/kernel'].t().reshape(
            s.c_out, s.c_in, 1, 1).contiguous(),
        params[f'{s.name}/pointwise_conv/bias'])) for s in specs]


def library_stack(weights, x_nchw, specs, gap):
    """Separable layers ``specs`` through cuDNN (``F.conv2d`` for both
    convolutions, in the weights' type; f32 with TF32 off): a yardstick for
    timing only, which the port's product path never calls."""
    import torch.nn.functional as F
    from buzzdetect_torch.ops.sepconv import same_pad
    x = x_nchw
    for s, (dw, dwb, pw, pwb) in zip(specs, weights):
        ph, pw_ = same_pad(s.h, s.stride), same_pad(s.w, s.stride)
        x = F.conv2d(F.pad(x, (pw_[0], pw_[1], ph[0], ph[1])), dw, dwb,
                     stride=s.stride, groups=s.c_in).relu_()
        x = F.conv2d(x, pw, pwb).relu_()
    return x.mean(dim=(2, 3)) if gap else x


# --- measured peaks and layers ----------------------------------------------

def measure_peaks(bf16=False):
    """Measured (matmul FLOP/s, f32 vector FLOP/s, bytes/s) on the card:
    medians of CUDA-event timings of a square ``torch.matmul`` (f32 with
    TF32 off at n = 4096, or bf16 at n = 8192), the FMA chain kernel, and a
    copy between two 1 GiB tensors."""
    import torch
    from buzzdetect_torch.ops import probe
    from buzzdetect_torch.ops.common import exact_f32
    from buzzdetect_torch.utils import cuda_time_ms

    exact_f32()
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)
    n, dtype = (8192, torch.bfloat16) if bf16 else (4096, torch.float32)
    a, b = (torch.randn((n, n), device=dev, generator=gen).to(dtype)
            for _ in range(2))
    matmul = 2 * n ** 3 / (cuda_time_ms(lambda: torch.matmul(a, b)) / 1e3)
    del a, b

    x = torch.randn(FMA_ELEMENTS, device=dev, generator=gen)
    vector = 2 * FMA_STEPS * FMA_ELEMENTS / (cuda_time_ms(
        lambda: probe.fma_chain(x, FMA_STEPS, FMA_A, FMA_B)) / 1e3)
    del x

    src = torch.zeros(1 << 28, device=dev)
    dst = torch.empty_like(src)
    bw = 2 * 4 * src.numel() / (cuda_time_ms(lambda: dst.copy_(src)) / 1e3)
    return matmul, vector, bw


def measure_layers(which, bf16, seconds):
    """Measured seconds of conv layers ``which`` at one chunk of
    ``seconds``: prefix differences of layer 1 + the cuDNN separable stack
    on the model_general_v3 weights and seeded patches."""
    import numpy as np
    import torch
    from buzzdetect_torch import config
    from buzzdetect_torch.models import yamnet
    from buzzdetect_torch.models.weights import params_from_numpy
    from buzzdetect_torch.ops.common import exact_f32
    from buzzdetect_torch.ops.sepconv import tail_specs
    from buzzdetect_torch.utils import cuda_time_ms

    exact_f32()
    dev = torch.device('cuda')
    path = os.path.join(config.resolve_dir(config.DIR_MODELS),
                        'model_general_v3', 'model.npz')
    with np.load(path) as z:
        params = params_from_numpy({k: z[k] for k in z.files},
                                   dev)['yamnet']
    b = int(seconds / 0.96)
    gen = torch.Generator(device=dev).manual_seed(3)
    patches = torch.randn((b, 96, 64), device=dev, generator=gen)
    dtype = torch.bfloat16 if bf16 else torch.float32
    mode = 'bf16' if bf16 else 'highest'
    specs = tail_specs(2, None)
    weights = library_weights(params, specs, dtype)

    def prefix(k):
        def fn():
            x = yamnet.layer1(params, patches, mode)
            if k >= 2:
                x = library_stack(weights[:k - 1],
                                  x.permute(0, 3, 1, 2).to(dtype),
                                  specs[:k - 1], gap=False)
            return x
        return fn

    times = {0: 0.0}
    for k in sorted(({k - 1 for k in which} | set(which)) - {0}):
        times[k] = cuda_time_ms(prefix(k)) / 1e3
        print(f'  measured prefix(1..{k}): {times[k] * 1e3:8.3f} ms',
              flush=True)
    return {k: times[k] - times[k - 1] for k in which}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description='Roofline table of the classify graph on one H100.')
    ap.add_argument('--seconds', type=float, default=960.0)
    ap.add_argument('--bf16', action='store_true')
    ap.add_argument('--measure', action='store_true',
                    help='measure the peaks on the card (and per-layer '
                         'times with --layers)')
    ap.add_argument('--layers', type=str, default='',
                    help='comma-separated conv layer numbers to measure '
                         '(prefix differences of the cuDNN stack)')
    ap.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                    help='cuda (default): the card\'s data-sheet peaks; cpu: '
                         'the H100 SXM data sheet, nothing measured')
    args = ap.parse_args(argv)
    if args.device == 'cpu' and (args.measure or args.layers):
        ap.error('--measure and --layers time the card; drop --device cpu')
    if args.layers and not args.measure:
        ap.error('--layers needs --measure')

    if args.device == 'cuda':
        import torch
        from buzzdetect_torch.models.classifier import resolve_device
        resolve_device('cuda')
        card = torch.cuda.get_device_name(0)
    else:
        card = 'H100 SXM (data sheet; no card)'
    f32_peak, bf16_peak, bw = peaks(card)
    matmul_peak = bf16_peak if args.bf16 else f32_peak
    label = 'bf16 tensor cores' if args.bf16 else 'f32, TF32 off'
    vector_peak, note = f32_peak, 'data sheet'

    measured_layers = {}
    if args.measure:
        print(f'measuring peaks on {card}...', flush=True)
        mm, vec, bw_m = measure_peaks(args.bf16)
        print(f'  matmul ({label}): {mm / 1e12:7.1f} TFLOP/s '
              f'(data sheet {matmul_peak / 1e12:.1f})')
        print(f'  fma chain (f32):    {vec / 1e12:7.1f} TFLOP/s '
              f'(data sheet {f32_peak / 1e12:.1f})')
        print(f'  streaming copy:     {bw_m / 1e9:7.0f} GB/s '
              f'(data sheet {bw / 1e9:.0f})', flush=True)
        matmul_peak, vector_peak, bw, note = mm, vec, bw_m, 'measured'
        if args.layers:
            which = sorted({int(x) for x in args.layers.split(',')})
            print(f'measuring conv layers {which}...', flush=True)
            measured_layers = measure_layers(which, args.bf16, args.seconds)

    dtype_bytes = 2 if args.bf16 else 4
    stages = list(graph_stages(args.seconds, dtype_bytes=dtype_bytes))
    print(f'\n{card}: chunk = {args.seconds:g} s '
          f'({int(args.seconds / 0.96)} patches), matmul = {label}; peaks '
          f'({note}): matmul {matmul_peak / 1e12:.1f} TFLOP/s, vector '
          f'{vector_peak / 1e12:.1f} TFLOP/s, memory {bw / 1e9:.0f} GB/s')
    hdr = (f'{"stage":34s} {"engine":6s} {"GFLOP":>8s} {"MB":>8s} '
           f'{"floor":>9s} {"bound":>6s}')
    print(hdr + (f' {"measured":>9s} {"x-floor":>7s}' if measured_layers
                 else ''))
    tot_f = tot_b = tot_t = 0.0
    layer_floor = {}
    for name, engine, flops, nbytes in stages:
        t, bound = lower_bound(flops, nbytes, engine, matmul_peak,
                               vector_peak, bw)
        tot_f, tot_b, tot_t = tot_f + flops, tot_b + nbytes, tot_t + t
        if name.startswith('layer'):
            n = int(name.split()[0][len('layer'):])
            layer_floor[n] = layer_floor.get(n, 0.0) + t
        print(f'{name:34s} {engine:6s} {flops / 1e9:8.2f} '
              f'{nbytes / 1e6:8.1f} {t * 1e3:7.4f}ms {bound:>6s}')
    if measured_layers:
        print('\nmeasured conv layers (prefix differences, cuDNN):')
        for k, t in sorted(measured_layers.items()):
            fl = layer_floor.get(k, 0.0)
            ratio = t / fl if fl else float('inf')
            print(f'  layer{k:<3d} measured {t * 1e3:8.3f} ms   '
                  f'floor {fl * 1e3:7.4f} ms   {ratio:6.1f}x off')
    print(f'\ntotals: {tot_f / 1e9:.1f} GFLOP, {tot_b / 1e6:.0f} MB minimum '
          f'memory traffic, roofline floor {tot_t * 1e3:.3f} ms '
          f'({args.seconds / tot_t:,.0f}x realtime)')
    print('floor assumes an unfused graph (every stage boundary goes through '
          'device memory); a fully fused kernel\'s floor is the compute '
          'column alone plus input+output traffic.', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
