"""Time the fused log-mel at every tile, on the card, and check its bits.

``csrc/logmel.cu`` runs at one of four tiles: FT frames a block (64, 32,
16 or 8, 4 FT threads). ``ops/logmel.launch_geometry`` picks one per launch
from the frame count, the batch and the SM count. This tool launches each
tile at B = 209 and B = 5 (20,064 and 480 frames of one seeded waveform),
on a batch of two ragged waveforms (``tools/compare_builds.LOGMEL_CASES``)
and on the benchmark's 1,667-patch chunk as the int16 wire. For each it
prints the device time (``torch.profiler``) and max |kernel - plain|,
marks the tile that ``launch_geometry`` picks, and checks that every tile
gives the first tile's bits (a frame's log-mel depends on nothing but its
samples). With ``--source``, another copy of ``logmel.cu`` (for example
one with a phase taken out) is built beside this checkout's library and
timed the same way.

    python -m buzzdetect_torch.tools.logmel_geometries [--source OTHER.cu ...]

Card only; exit code 0 unless a launch fails or a tile's bits differ.
"""

import argparse
import sys

import torch

# the benchmark's chunk: 1,667 patches of 96 frames
BENCHMARK_FRAMES = 1667 * 96


def inputs(device):
    """``compare_builds.logmel_inputs`` and the benchmark's chunk as a
    seeded int16 wire."""
    from buzzdetect_torch.ops import logmel
    from buzzdetect_torch.tools.compare_builds import logmel_inputs
    xs = logmel_inputs(device)
    gen = torch.Generator(device=device).manual_seed(1)
    n = logmel.WINDOW + logmel.HOP * (BENCHMARK_FRAMES - 1)
    xs['1,667 patches, int16'] = torch.randint(
        -3277, 3277, (1, n), device=device, generator=gen,
        dtype=torch.int32).to(torch.int16)
    return xs


def main(argv=None):
    ap = argparse.ArgumentParser(
        description='Time the fused log-mel at every tile on the card and '
                    'check that each gives the same bits.')
    ap.add_argument('--source', action='append', default=[],
                    help='another logmel.cu to build and time beside this '
                         'checkout\'s (repeatable)')
    args = ap.parse_args(argv)
    from buzzdetect_torch.models.classifier import resolve_device
    from buzzdetect_torch.ops import logmel
    from buzzdetect_torch.ops.frontend import FrontendConfig
    from buzzdetect_torch.tools.compare_builds import build_other
    from buzzdetect_torch.utils import cuda_device_ms
    device = resolve_device('cuda')
    cfg = FrontendConfig()
    libs = {'this checkout': logmel.load_kernels()}
    for path in args.source:
        libs[path] = build_other(path, logmel.bind)
    sms, blocks = logmel._card(device, libs['this checkout'])
    print(f'device: {torch.cuda.get_device_name(device)}, {sms} SMs; '
          f'blocks an SM runs at once per FT: {blocks}', flush=True)
    ok = True
    with torch.inference_mode():
        xs = inputs(device)
        refs = {k: logmel.log_mel_spectrogram_fused_plain(x, cfg)
                for k, x in xs.items()}
        picks = {k: logmel.geometry_on(device, 1 + (x.shape[1] - 400) // 160,
                                       x.shape[0]) for k, x in xs.items()}
        for name, lib in libs.items():
            first = {}
            for ft in logmel.FRAME_TILES:
                parts = []
                for label, x in xs.items():
                    def run(x=x):
                        return logmel._launch(x, cfg, lib=lib, ft=ft)
                    out = run()
                    err = float((out - refs[label]).abs().max())
                    same = torch.equal(first.setdefault(label, out), out)
                    ok &= same
                    mark = '*' if picks[label].ft == ft else ''
                    parts.append(f'{label}{mark} {cuda_device_ms(run):.4f} '
                                 f'ms (max |d| {err:.2g}'
                                 f'{"" if same else ", BITS DIFFER"})')
                print(f'{name}: FT={ft}: ' + ', '.join(parts), flush=True)
    print('* the tile launch_geometry picks; bits held against FT='
          f'{logmel.FRAME_TILES[0]}: {"equal" if ok else "DIFFER"}',
          flush=True)
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
