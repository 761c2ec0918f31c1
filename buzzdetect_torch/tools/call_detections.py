"""Call detection EVENTS from archived activations — no re-analysis.

The recommended workflow (same as the reference ecosystem's, where the
buzzr companion does this step — reference
`docs/source/result_files.rst:76`): analyze once in activations mode,
archive the scores, then threshold them at any precision after the fact
and coalesce detected frames into events (start/end/duration, peak and
mean activation). Works on finalized result CSVs and on `trim`'s
compressed `_buzztrim.npz` archives.

Usage:
    python -m buzzdetect_torch.tools.call_detections \
        --dir_results ./out --precision 0.95
    python -m buzzdetect_torch.tools.call_detections \
        --dir_results ./out --threshold -1.2 \
        --classes ins_buzz ins_trill --out events.csv

Counterpart of ``tools/call_detections.py`` on the port; ``main`` takes
``argv``.
"""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--dir_results', required=True,
                    help='directory of archived results (CSV or trimmed)')
    from buzzdetect_torch.write.detections import (add_calibration_args,
                                                   check_calibration_args)
    add_calibration_args(ap)
    ap.add_argument('--modelname', default=None,
                    help='model whose metrics calibrate --precision '
                         '(default: the results directory\'s manifest)')
    ap.add_argument('--classes', nargs='+', default=['ins_buzz'])
    ap.add_argument('--merge_gap', type=float, default=None,
                    help='max gap (s) between detected frames of one event '
                         '(default: 1.5x the frame hop)')
    ap.add_argument('--out', default=None,
                    help='write the events here (default: print a summary '
                         'only). A file path for csv; a DIRECTORY for '
                         'audacity/raven (one track/table per recording)')
    ap.add_argument('--format', default='csv',
                    choices=['csv', 'audacity', 'raven', 'clips'],
                    help='output format: combined events CSV (default), '
                         'Audacity label tracks (File > Import > Labels), '
                         'Raven Pro selection tables (one per '
                         'recording — Raven times are per-sound), or '
                         'clips: one reviewable WAV snippet per event cut '
                         'from the source audio (needs --dir_audio)')
    ap.add_argument('--dir_audio', default=None,
                    help='source audio for --format clips: the directory '
                         'the analysis ran over (or a single file)')
    ap.add_argument('--pad', type=float, default=1.0,
                    help='context seconds around each clip (clips only)')
    ap.add_argument('--clip_rate', type=int, default=16000,
                    help='clip samplerate: 16000 (default) is the mono '
                         'view the detector heard; 0 keeps the '
                         'recording\'s native rate (clips only)')
    args = ap.parse_args(argv)
    check_calibration_args(ap, args)
    if args.format != 'csv' and args.out is None:
        ap.error(f'--format {args.format} requires --out')
    if args.format == 'clips' and args.dir_audio is None:
        ap.error('--format clips requires --dir_audio')

    from buzzdetect_torch.write.detections import (call_detections_directory,
                                                   write_audacity_labels,
                                                   write_event_clips,
                                                   write_raven_tables)
    rows = call_detections_directory(
        args.dir_results, threshold=args.threshold,
        precision=args.precision, recall=args.recall,
        modelname=args.modelname,
        classes=args.classes, merge_gap_s=args.merge_gap,
        path_out=args.out if args.format == 'csv' else None,
        on_skip=lambda path, why: print(f'skipping {path}: {why}',
                                        file=sys.stderr))
    if args.format == 'audacity':
        for p in write_audacity_labels(rows, args.out):
            print(f'wrote {p}')
    elif args.format == 'raven':
        for p in write_raven_tables(rows, args.out):
            print(f'wrote {p}')
    elif args.format == 'clips':
        for p in write_event_clips(
                rows, args.dir_audio, args.out, pad_s=args.pad,
                rate=args.clip_rate,
                on_skip=lambda ident, why: print(
                    f'skipping {ident}: {why}', file=sys.stderr)):
            print(f'wrote {p}')

    idents = sorted({r['ident'] for r in rows})
    total_s = sum(r['duration'] for r in rows)
    print(f'{len(rows)} events across {len(idents)} files '
          f'({total_s:.1f} s detected)')
    for ident in idents:
        mine = [r for r in rows if r['ident'] == ident]
        print(f'  {ident}: {len(mine)} events, '
              f'{sum(r["duration"] for r in mine):.1f} s')
    if args.out and args.format == 'csv':
        print(f'wrote {args.out}')


if __name__ == '__main__':
    main()
