"""Are this checkout's conv kernels bit for bit another build's?

Builds a second ``csrc/sepconv.cu`` (for example a parent commit's,
unpacked beside this checkout) with the same ``nvcc`` flags, loads it next
to this checkout's library, and runs the same stacks through both on the
card: ``fused_front`` (layers 2-7), ``fused_tail`` (layers 8-14 + pooling)
and layers 4-7 in exact f32, and the fronts and tails in bf16 and HIGH, at
B = 209 (one 200 s chunk) and B = 5, on seeded inputs with the bundle's
weights. Every pair must be equal (``torch.equal``): resume is
byte-identical only if a redesigned kernel keeps its arithmetic. Then it
times each exact-f32 layer 2-14 alone at B = 209 through both libraries,
in turns (other, this, this, other; the median of 15 CUDA-event timings
each, the better of each pair kept), so that a layer the redesign made
slower shows on the same card in the same run.

    python -m buzzdetect_torch.tools.compare_builds \\
        --against OTHER_CHECKOUT/buzzdetect_torch/csrc/sepconv.cu

One line per case and per timed layer; exit code 0 only when every case
is equal.
"""

import argparse
import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np
import torch

from buzzdetect_torch.ops import _build, sepconv

# name -> (layers, gap, modes)
CASES = {'fused_front': (dict(start_layer=2, stop_layer=8), False,
                         sepconv.MODES),
         'fused_tail': (dict(start_layer=8, stop_layer=None), True,
                        sepconv.MODES),
         'fused_tail[4:8]': (dict(start_layer=4, stop_layer=8), False,
                             ('highest',))}
BATCHES = (209, 5)


def build_other(path):
    """Compile ``path`` (a copy of ``csrc/sepconv.cu``, its headers beside
    it) into ``csrc/build/`` and load it, bound as ``sepconv.bind`` binds
    this checkout's."""
    with open(path, 'rb') as f:
        digest = hashlib.sha256(f.read() + ' '.join(_build.NVCC_FLAGS)
                                .encode()).hexdigest()[:16]
    out = os.path.join(_build.DIR_BUILD, f'libother_{digest}.so')
    if not os.path.exists(out):
        os.makedirs(_build.DIR_BUILD, exist_ok=True)
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, '-o', out,
                               path], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed on {path}:\n{proc.stdout}'
                               f'{proc.stderr}')
    return sepconv.bind(ctypes.CDLL(out))


def inputs(params, mode, device, seed=0):
    """Seeded log-mel-like patches through layer 1, and the plain front's
    outputs entering layers 4 and 8, at the largest batch."""
    from buzzdetect_torch.models import yamnet
    gen = torch.Generator(device=device).manual_seed(seed)
    patches = torch.randn((BATCHES[0], 96, 64, 1), device=device,
                          generator=gen)
    l1 = yamnet.layer1(params, patches, mode)
    b = BATCHES[0]
    return {'fused_front': l1,
            'fused_tail': sepconv.fused_front_plain(params, l1, mode=mode)
            .reshape(b, 6, 4, 512),
            'fused_tail[4:8]': sepconv.fused_front_plain(
                params, l1, start_layer=2, stop_layer=4, mode=mode)
            .reshape(b, 24, 16, 128)}


def compare(other, device):
    """{(case, mode, batch): equal} over every case, this checkout's
    library against ``other``."""
    yam = _weights(device)
    sepconv.exact_f32()
    results = {}
    with torch.inference_mode():
        for mode in sepconv.MODES:
            params = sepconv.pack_params(yam, mode)
            xs = inputs(params, mode, device)
            for name, (layers, gap, modes) in CASES.items():
                if mode not in modes:
                    continue
                specs = sepconv.tail_specs(layers['start_layer'],
                                           layers['stop_layer'])
                for b in BATCHES:
                    x = xs[name][:b].contiguous()
                    ops = sepconv._check(params, x, specs, mode)
                    ours = sepconv._launch(ops, x, specs, gap, mode)
                    theirs = sepconv._launch(ops, x, specs, gap, mode,
                                             lib=other)
                    torch.cuda.synchronize(device)
                    same = torch.equal(ours, theirs)
                    d = float((ours - theirs).abs().max())
                    print(f'{name} [{mode}] B={b} {tuple(ours.shape)}: '
                          f'{"bit-identical" if same else "DIFFERENT"}'
                          f' (max |d| {d:.3g})', flush=True)
                    results[name, mode, b] = same
    return results


def time_layers(other, device):
    """{layer: (this ms, other ms)} of every exact-f32 layer alone at the
    largest batch, each on its input from the plain stack."""
    from buzzdetect_torch.utils import cuda_time_ms
    params = sepconv.pack_params(_weights(device), 'highest')
    b = BATCHES[0]
    times = {}
    with torch.inference_mode():
        x = inputs(params, 'highest', device)['fused_front']
        for s in sepconv.tail_specs(2, None):
            ops = sepconv._check(params, x, (s,), 'highest')
            runs = [lambda lib=lib: sepconv._launch(ops, x, (s,), False,
                                                    'highest', lib=lib)
                    for lib in (other, None, None, other)]
            t = [cuda_time_ms(run) for run in runs]
            ours, theirs = min(t[1:3]), min(t[0], t[3])
            times[s.index] = ours, theirs
            print(f'layer {s.index} (C={s.c_in}, F={s.c_out}, B={b}): this '
                  f'{ours:.4f} ms, other {theirs:.4f} ms (this / other '
                  f'{ours / theirs:.2f}x)', flush=True)
            x = sepconv.fused_tail_plain(
                params, x, start_layer=s.index, stop_layer=s.index + 1,
                gap=False).reshape(b, s.h_out, s.w_out, s.c_out)
    return times


def _weights(device):
    from buzzdetect_torch.config import DIR_MODELS
    from buzzdetect_torch.models.weights import params_from_numpy
    with np.load(os.path.join(DIR_MODELS, 'model_general_v3',
                              'model.npz')) as z:
        arrays = {k: z[k] for k in z.files}
    return params_from_numpy(arrays, device)['yamnet']


def main(argv=None):
    ap = argparse.ArgumentParser(
        description='Run the conv stacks through this checkout\'s '
                    'csrc/sepconv.cu and another build of it, and check '
                    'that their outputs are equal bit for bit.')
    ap.add_argument('--against', required=True,
                    help='path of the other sepconv.cu')
    args = ap.parse_args(argv)
    from buzzdetect_torch.models.classifier import resolve_device
    device = resolve_device('cuda')
    print(f'device: {torch.cuda.get_device_name(device)}; this checkout '
          f'against {args.against}', flush=True)
    other = build_other(args.against)
    results = compare(other, device)
    bad = [k for k, same in results.items() if not same]
    print(f'{len(results) - len(bad)} of {len(results)} cases '
          f'bit-identical', flush=True)
    time_layers(other, device)
    return 1 if bad else 0


if __name__ == '__main__':
    sys.exit(main())
