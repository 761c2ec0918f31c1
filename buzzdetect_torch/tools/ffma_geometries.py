"""Time the exact-f32 conv layers at every tile, on the card.

``csrc/sepconv.cu`` runs an exact-f32 layer on the wide tile
(``sep_layer_kernel``, BN = min(F, 256), TM = 5 or 4 positions a thread)
or on one of 12 narrow tiles (``sep_narrow_kernel``, BN = 8, 16, 32, 64 x
TM = 1, 2, 4), as ``ffma_geometry`` picks from the shapes (mirrored by
``ops/sepconv.ffma_geometry``). This tool launches one layer at each of
the 14 tiles (``bz_sep_layer_at``) for each layer shape and batch asked,
on seeded non-negative activations with the bundle's weights, checks that
every tile's output equals the first's bit for bit, and prints each
tile's device time alone (``utils.cuda_device_ms``), marking the one the
library picks (a wide tile named by its TM, a narrow one BN x BM: output
channels x positions a block).
Then, for each ``--load-costs`` value, it prices the tiles with
``ffma_cost`` at that weight (through the mirror) and prints how far its
picks lie from the fastest tile: the mean and the worst of pick / fastest,
and the tail layers (8-14) at B <= 8 that would launch fewer than 64
blocks.

    python -m buzzdetect_torch.tools.ffma_geometries \\
        [--layers 3,4,5,6,7,8,13,14] [--batches 1,2,3,5,8,16,32,64,128] \\
        [--load-costs 4,8,16,32]

It first prints each tile's registers a thread and spilled bytes, from
``nvcc -Xptxas -v`` on ``csrc/sepconv.cu`` (``ops/_build.resources``).

Card only; exit code 0 unless a launch fails, a tile's output differs or a
tile spills.
"""

import argparse
import os
import statistics
import sys

import numpy as np
import torch

# the wide tile at TM = 5: the first launched, each other tile's reference
WIDE = ('wide', 0, 5)
TILES = (WIDE, ('wide', 0, 4)) + tuple(
    ('narrow', bn, tm) for bn in (8, 16, 32, 64) for tm in (1, 2, 4))


def tile_of(g):
    """A Geometry's tile, as TILES names it."""
    return ('wide' if g.kernel == 'wide' else 'narrow',
            0 if g.kernel == 'wide' else g.bn, g.tm)


def label(tile):
    """A wide tile as 'wide TM<TM>', a narrow one as BN x BM (output
    channels x positions a block), as chip_smoke.py and compare_builds
    print narrow tiles."""
    kernel, bn, tm = tile
    return f'wide TM{tm}' if kernel == 'wide' else f'{bn}x{256 // bn * tm}'


def layer_at(lib, x, y, ops, s, tile):
    """Launch layer ``s`` on ``x`` into ``y`` at ``tile`` through
    ``bz_sep_layer_at``; False for a tile that does not fit."""
    from buzzdetect_torch.ops import sepconv
    from buzzdetect_torch.ops.common import device_scope
    ptrs = np.array([t.data_ptr() for t in ops], np.int64)
    with device_scope(x.device):
        code = lib.bz_sep_layer_at(
            x.data_ptr(), y.data_ptr(), x.shape[0], ptrs.ctypes.data,
            sepconv._layer_dims((s,)).ctypes.data, int(tile[0] == 'narrow'),
            tile[1], tile[2], torch.cuda.current_stream().cuda_stream)
    if code == -1:
        return False
    sepconv.LIBRARY.check(lib, 'bz_sep_layer_at', code)
    return True


def regret(times, load_cost, card):
    """(mean, worst) of pick / fastest over ``times`` ({(layer, B): {tile:
    ms}}), and the tail layers at B <= 8 under 64 blocks, with the
    mirror's rule at ``load_cost``."""
    from buzzdetect_torch.ops import sepconv
    saved = sepconv._LOAD_COST
    sepconv._LOAD_COST = load_cost
    try:
        ratios, thin = [], []
        for (index, b), ts in times.items():
            g = sepconv.ffma_geometry(sepconv.tail_specs(index, index + 1)[0],
                                      b, card)
            ratios.append(ts[tile_of(g)] / min(ts.values()))
            if index >= 8 and b <= 8 and g.blocks < 64:
                thin.append((index, b, g.blocks))
    finally:
        sepconv._LOAD_COST = saved
    return statistics.mean(ratios), max(ratios), thin


def main(argv=None):
    ap = argparse.ArgumentParser(
        description='Time each exact-f32 conv layer at every tile on the '
                    'card, check each against the first bit for bit, '
                    'and price the grid rule\'s picks.')
    ap.add_argument('--layers', default='3,4,5,6,7,8,13,14',
                    help='sep layers (comma-separated; 9-12 have layer '
                         '8\'s shape)')
    ap.add_argument('--batches', default='1,2,3,5,8,16,32,64,128')
    ap.add_argument('--load-costs', default='4,8,16,32',
                    help='ffma_cost weights of a float brought in, to '
                         'price the picks at')
    args = ap.parse_args(argv)
    from buzzdetect_torch.config import DIR_MODELS
    from buzzdetect_torch.models.classifier import resolve_device
    from buzzdetect_torch.models.weights import params_from_numpy
    from buzzdetect_torch.ops import sepconv
    from buzzdetect_torch.utils import cuda_device_ms
    device = resolve_device('cuda')
    lib = sepconv.load_kernels()
    card = sepconv.library_card(lib)
    print(f'device: {torch.cuda.get_device_name(device)}; {card[0]} SMs, '
          f'{card[1]} B of shared memory per SM, {card[2]} per block',
          flush=True)
    from buzzdetect_torch.ops import _build
    tiles = [k for k in _build.resources('sepconv')
             if k['kernel'].startswith(('sep_layer_kernel', 'sep_narrow'))]
    spills = [k['kernel'] for k in tiles
              if k['spill_stores'] or k['spill_loads']]
    print('registers a thread (spilled bytes stored / loaded), nvcc '
          '-Xptxas -v: ' + ', '.join(
              f'{k["kernel"]} {k.get("registers")} ({k["spill_stores"]} / '
              f'{k["spill_loads"]})' for k in tiles), flush=True)
    with np.load(os.path.join(DIR_MODELS, 'model_general_v3',
                              'model.npz')) as z:
        params = params_from_numpy({k: z[k] for k in z.files},
                                   device)['yamnet']
    gen = torch.Generator(device=device).manual_seed(0)
    times, bad = {}, 0
    with torch.inference_mode():
        for index in (int(v) for v in args.layers.split(',')):
            s = sepconv.tail_specs(index, index + 1)[0]
            ops = sepconv._check(params, torch.zeros(
                1, s.h, s.w, s.c_in, device=device), (s,), 'highest')[0]
            for b in (int(v) for v in args.batches.split(',')):
                x = torch.relu(torch.randn((b, s.h, s.w, s.c_in),
                                           device=device, generator=gen))
                y = torch.empty((b * s.h_out * s.w_out, s.c_out),
                                device=device)
                pick = tile_of(sepconv.library_geometry((s,), b, card,
                                                        lib)[0])
                ts, ref = {}, None
                for tile in TILES:
                    if not layer_at(lib, x, y, ops, s, tile):
                        continue
                    torch.cuda.synchronize(device)
                    if ref is None:
                        ref = y.clone()
                    elif not torch.equal(y, ref):
                        bad += 1
                        print(f'DIFFERENT: layer {index} B={b} {tile}: max '
                              f'|d| {float((y - ref).abs().max()):.3g}',
                              flush=True)
                    ts[tile] = cuda_device_ms(
                        lambda tile=tile: layer_at(lib, x, y, ops, s, tile))
                times[index, b] = ts
                best = min(ts, key=ts.get)
                print(f'layer {index} (C={s.c_in}, F={s.c_out}) B={b}: pick '
                      f'{label(pick)} {ts[pick]:.4f} ms, fastest '
                      f'{label(best)} {ts[best]:.4f} ms | ' + ' '.join(
                          f'{label(t)} {v:.4f}' for t, v in ts.items()),
                      flush=True)
    for cost in (int(v) for v in args.load_costs.split(',')):
        mean, worst, thin = regret(times, cost, card)
        mark = ' (the library\'s)' if cost == sepconv._LOAD_COST else ''
        print(f'LOAD_COST {cost}{mark}: pick / fastest mean {mean:.3f}, '
              f'worst {worst:.3f}; tail layers at B <= 8 under 64 blocks: '
              f'{thin}', flush=True)
    print(f'{bad} tiles differ from the first; FFMA tiles that spill: '
          f'{spills or "none"}', flush=True)
    return 1 if bad or spills else 0


if __name__ == '__main__':
    sys.exit(main())
