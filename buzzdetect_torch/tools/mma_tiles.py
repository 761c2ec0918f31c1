"""Time the bf16 conv layers on each tensor-core tile, on the card.

``csrc/sepconv.cu`` runs a BF16 layer on ``sep_layer_mma_kernel``'s tile
(BN = min(F, 256) channels x 16-128 positions) or, where F is a multiple of
256, on the wide tile (``sep_mma_wide_kernel``, 256 channels x 128 or 64
positions), as ``mma_geometry`` picks from the shapes. This tool launches
each layer asked at each tile (``bz_mma_layer_at``) for each batch asked,
on seeded non-negative activations with the bundle's weights, checks that
each wide tile's output equals ``sep_layer_mma_kernel``'s bit for bit, and
prints each tile's device time alone (``utils.cuda_device_ms``) beside the
layer's floor: its f32 input read once and its f32 output written once at
the card's sheet bandwidth. It marks the tile the library picks and the
fastest tile: its rows at B = 32, 64, 209 and 1,667 are what ``mma_cost``
in ``csrc/sepconv.cu`` is fitted to (PERF.md).

    python -m buzzdetect_torch.tools.mma_tiles [--layers 5,6,...,14] \\
        [--batches 1667,209,64,32,8,1]

It first prints the tensor-core kernels' registers a thread and spilled
bytes, from ``nvcc -Xptxas -v`` on ``csrc/sepconv.cu``
(``ops/_build.resources``).

Card only; exit code 0 unless a launch fails, a tile's output differs or
the wide tile spills.
"""

import argparse
import os
import sys

import numpy as np
import torch

# sep_layer_mma_kernel's tile (each other tile's reference), and the wide
# tile at 128 and 64 rows, as bz_mma_layer_at names them
TILES = (0, 128, 64)
# the kernels whose registers and spills are printed
KERNELS = ('sep_layer_mma_kernel', 'sep_mma_wide_kernel')


def label(tile):
    return 'mma' if tile == 0 else f'wide{tile}'


def layer_at(lib, x, y, ops, s, mode, tile):
    """Launch layer ``s`` on ``x`` into ``y`` at ``tile`` (one of TILES, or
    -1 for the library's pick) through ``bz_mma_layer_at``; the tile it
    launched, as TILES names it, or None for a tile that does not fit or
    take the layer."""
    from buzzdetect_torch.ops import sepconv
    from buzzdetect_torch.ops.common import device_scope
    ptrs = np.array([t.data_ptr() for t in ops], np.int64)
    launched = np.zeros(1, np.int32)
    with device_scope(x.device):
        code = lib.bz_mma_layer_at(
            x.data_ptr(), y.data_ptr(), x.shape[0], ptrs.ctypes.data,
            sepconv._layer_dims((s,)).ctypes.data, sepconv._MODE_CODE[mode],
            tile, launched.ctypes.data,
            torch.cuda.current_stream().cuda_stream)
    if code == -1:
        return None
    sepconv.LIBRARY.check(lib, 'bz_mma_layer_at', code)
    return int(launched[0])


def resources():
    """``nvcc -Xptxas -v``'s registers and spills of the tensor-core
    kernels: a list of dicts (``_build.parse_ptxas``)."""
    from buzzdetect_torch.ops import _build
    return [k for k in _build.resources('sepconv')
            if k['kernel'].startswith(KERNELS)]


def floor_ms(s, b, bytes_per_s):
    """Layer ``s``'s f32 activations at B = ``b``, its input read once and
    its output written once, at ``bytes_per_s``: milliseconds."""
    n = b * (s.h * s.w * s.c_in + s.h_out * s.w_out * s.c_out) * 4
    return 1e3 * n / bytes_per_s


def layer_rows(params, layers, batches, bytes_per_s, mode='bf16', seed=0,
               tolerance=None):
    """Each layer of ``layers`` at each B of ``batches`` in ``mode``, on
    ``params`` (the bundle's yamnet dict, on the card): a dict a pair with
    the library's pick (``pick``, as TILES names it), each tile's device ms
    (``ms``: {tile: ms}, a tile that does not fit left out), the floor
    (``floor_ms``) and the tiles whose output differs from
    ``sep_layer_mma_kernel``'s (``differ``). With ``tolerance`` (mode, ref
    -> (atol, rtol)) also ``plain``: (max |kernel - plain|, atol, within
    it), sep_layer_mma_kernel's output (every other tile's bits) against
    the layer's plain version."""
    from buzzdetect_torch.ops import sepconv
    from buzzdetect_torch.utils import cuda_device_ms
    lib = sepconv.load_kernels()
    packed = sepconv.pack_params(params, mode)
    device = next(iter(params.values())).device
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = []
    with torch.inference_mode():
        for index in layers:
            s = sepconv.tail_specs(index, index + 1)[0]
            ops = sepconv._check(packed, torch.zeros(
                1, s.h, s.w, s.c_in, device=device), (s,), mode)[0]
            for b in batches:
                x = torch.relu(torch.randn((b, s.h, s.w, s.c_in),
                                           device=device, generator=gen))
                y = torch.empty((b * s.h_out * s.w_out, s.c_out),
                                device=device)
                pick = layer_at(lib, x, y, ops, s, mode, -1)
                ms, ref, differ = {}, None, []
                for tile in TILES:
                    y.fill_(float('nan'))
                    if layer_at(lib, x, y, ops, s, mode, tile) is None:
                        continue
                    torch.cuda.synchronize(device)
                    if ref is None:
                        ref = y.clone()
                    elif not torch.equal(y, ref):
                        differ.append(tile)
                    ms[tile] = cuda_device_ms(
                        lambda tile=tile: layer_at(lib, x, y, ops, s, mode,
                                                   tile))
                row = dict(layer=index, b=b, pick=pick, ms=ms,
                           floor_ms=floor_ms(s, b, bytes_per_s),
                           differ=differ)
                if tolerance is not None:
                    plain = sepconv.fused_tail_plain(
                        packed, x, start_layer=index, stop_layer=index + 1,
                        gap=False, mode=mode).reshape(ref.shape)
                    atol, rtol = tolerance(mode, plain)
                    row['plain'] = (float((ref - plain).abs().max()), atol,
                                    torch.allclose(ref, plain, atol=atol,
                                                   rtol=rtol))
                rows.append(row)
    return rows


def row_line(row):
    """One row as a line: the pick and each tile's ms against the floor,
    the fastest tile's ms against the pick's, and the plain check if
    made."""
    ms, floor, pick = row['ms'], row['floor_ms'], row['pick']
    best = min(ms, key=ms.get)
    plain = row.get('plain')
    return (f'layer {row["layer"]} B={row["b"]}: pick {label(pick)} '
            f'{ms[pick]:.4f} ms ({ms[pick] / ms[best]:.3f}x the fastest, '
            f'{label(best)}) | '
            + ' '.join(f'{label(t)} {v:.4f} ({v / floor:.2f}x floor)'
                       for t, v in ms.items())
            + f' | floor {floor:.4f} ms'
            + (f' | max |mma - plain| {plain[0]:.3g} (atol {plain[1]:.3g})'
               if plain else '')
            + (f' | DIFFERENT: {[label(t) for t in row["differ"]]}'
               if row['differ'] else ''))


def main(argv=None):
    ap = argparse.ArgumentParser(
        description='Time each bf16 conv layer at each tensor-core tile on '
                    'the card, and check the wide tiles against '
                    'sep_layer_mma_kernel bit for bit.')
    ap.add_argument('--layers', default='5,6,7,8,9,10,11,12,13,14')
    ap.add_argument('--batches', default='1667,209,64,32,8,1')
    args = ap.parse_args(argv)
    from buzzdetect_torch.config import DIR_MODELS
    from buzzdetect_torch.models.classifier import resolve_device
    from buzzdetect_torch.models.weights import params_from_numpy
    from buzzdetect_torch.tools.roofline import peaks
    device = resolve_device('cuda')
    name = torch.cuda.get_device_name(device)
    print(f'device: {name}', flush=True)
    kernels = resources()
    spills = [k['kernel'] for k in kernels
              if k['kernel'].startswith('sep_mma_wide_kernel')
              and (k['spill_stores'] or k['spill_loads'])]
    print('registers a thread (spilled bytes stored / loaded), nvcc '
          '-Xptxas -v: ' + ', '.join(
              f'{k["kernel"]} {k.get("registers")} ({k["spill_stores"]} / '
              f'{k["spill_loads"]})' for k in kernels), flush=True)
    with np.load(os.path.join(DIR_MODELS, 'model_general_v3',
                              'model.npz')) as z:
        params = params_from_numpy({k: z[k] for k in z.files},
                                   device)['yamnet']
    rows = layer_rows(params, [int(v) for v in args.layers.split(',')],
                      [int(v) for v in args.batches.split(',')],
                      peaks(name)[2])
    for row in rows:
        print(row_line(row), flush=True)
    bad = sum(bool(r['differ']) for r in rows)
    print(f'{bad} layers with a tile that differs from '
          f'sep_layer_mma_kernel; wide tiles that spill: '
          f'{spills or "none"}', flush=True)
    return 1 if bad or spills else 0


if __name__ == '__main__':
    sys.exit(main())
