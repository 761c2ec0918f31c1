"""Time the fused log-mel at every launch geometry, on the card.

``csrc/logmel.cu`` runs at one of six geometries: FT frames per
thread-block cluster (128, 64 or 32) and CS blocks per cluster (2 or 4).
``ops/logmel.launch_geometry`` picks one per launch from the SM count and
``cudaOccupancyMaxActiveClusters``. This tool launches each geometry at B =
209 and B = 5 (20,064 and 480 frames of one seeded waveform) and on a batch
of two ragged waveforms (``tools/compare_builds.LOGMEL_CASES``). For each
it prints the device time (``torch.profiler``) and max |kernel - plain|,
and it marks the geometry that ``launch_geometry`` picks. With
``--source``, another copy of ``logmel.cu`` (for example one with a phase
taken out) is built beside this checkout's library and timed the same way.

    python -m buzzdetect_torch.tools.logmel_geometries [--source OTHER.cu ...]

Card only; exit code 0 unless a launch fails.
"""

import argparse
import sys

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(
        description='Time the fused log-mel at every (FT, CS) launch '
                    'geometry on the card.')
    ap.add_argument('--source', action='append', default=[],
                    help='another logmel.cu to build and time beside this '
                         'checkout\'s (repeatable)')
    args = ap.parse_args(argv)
    from buzzdetect_torch.models.classifier import resolve_device
    from buzzdetect_torch.ops import logmel
    from buzzdetect_torch.ops.frontend import FrontendConfig
    from buzzdetect_torch.tools.compare_builds import (
        build_other, logmel_inputs)
    from buzzdetect_torch.utils import cuda_device_ms
    device = resolve_device('cuda')
    cfg = FrontendConfig()
    libs = {'this checkout': logmel.load_kernels()}
    for path in args.source:
        libs[path] = build_other(path, logmel.bind)
    sms, clusters = logmel._card(device, libs['this checkout'])
    print(f'device: {torch.cuda.get_device_name(device)}, {sms} SMs; '
          f'cudaOccupancyMaxActiveClusters per (FT, CS): {clusters}',
          flush=True)
    ops = logmel._operands(cfg, device)
    with torch.inference_mode():
        xs = logmel_inputs(device)
        refs = {k: logmel.log_mel_spectrogram_fused_plain(x, cfg)
                for k, x in xs.items()}
        picks = {k: logmel.geometry_on(device, 1 + (x.shape[1] - 400) // 160,
                                       x.shape[0]) for k, x in xs.items()}
        for name, lib in libs.items():
            for ft in logmel.FRAME_TILES:
                for cs in logmel.CLUSTER_SIZES:
                    parts = []
                    for label, x in xs.items():
                        def run(x=x):
                            b, n = x.shape
                            n_frames = 1 + (n - logmel.WINDOW) // logmel.HOP
                            out = torch.empty((b, n_frames, logmel.MELS),
                                              device=device)
                            logmel._check_code(lib, 'bz_logmel', lib.bz_logmel(
                                x.data_ptr(), out.data_ptr(),
                                ops['chunks'].data_ptr(),
                                ops['nyq'].data_ptr(), ops['mel'].data_ptr(),
                                b, n, n_frames, cfg.log_offset, ft, cs,
                                torch.cuda.current_stream().cuda_stream))
                            return out
                        err = float((run() - refs[label]).abs().max())
                        mark = '*' if (picks[label].ft, picks[label].cs) == (
                            ft, cs) else ''
                        parts.append(f'{label}{mark} {cuda_device_ms(run):.4f}'
                                     f' ms (max |d| {err:.2g})')
                    print(f'{name}: FT={ft} CS={cs}: ' + ', '.join(parts),
                          flush=True)
    print('* the geometry launch_geometry picks', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
