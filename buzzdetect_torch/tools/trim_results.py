"""Compact finalized result CSVs into small trimmed archives.

The capability of the reference ecosystem's ``buzzr::trim_directory()``
(reference docs/source/result_files.rst:104-107): keep only the classes
of interest, coarsen the activation rounding, store compressed. Season-
scale result sets shrink ~30:1 with no meaningful information loss, and
``call_detections`` / ``activity_report`` read trimmed archives exactly
like CSVs. Start times stay EXACT at any recording
length (stored as scaled integers of the CSV's rounded column).

Note the ratio claim is for real recordings (hours of rows); on tiny
test files the npz container overhead can exceed the CSV and the tool
says so instead of pretending.

Usage:
    python -m buzzdetect_torch.tools.trim_results \
        --dir_results ./out
    python -m buzzdetect_torch.tools.trim_results \
        --dir_results ./out \
        --classes ins_buzz --decimals 1 --remove_original

Counterpart of ``tools/trim_results.py`` on the port; ``main`` takes
``argv``.
"""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--dir_results', required=True,
                    help='directory of finalized <ident>_buzzdetect.csv')
    ap.add_argument('--classes', nargs='+', default=['ins_buzz'],
                    help="classes to keep, or 'all'")
    ap.add_argument('--decimals', type=int, default=1,
                    help='activation rounding in the archive (default 1, '
                         'like buzzr; the CSVs carry 2)')
    ap.add_argument('--remove_original', action='store_true',
                    help='delete each CSV after its archive is written')
    args = ap.parse_args(argv)
    if args.decimals < 0:
        ap.error('--decimals must be >= 0')

    from buzzdetect_torch.write.trim import trim_directory
    classes = 'all' if args.classes == ['all'] else tuple(args.classes)
    skipped = []

    def on_skip(path, why):
        skipped.append(path)
        print(f'skipping {path}: {why}', file=sys.stderr)

    n, before, after = trim_directory(
        args.dir_results, classes_keep=classes, decimals=args.decimals,
        remove_original=args.remove_original, on_skip=on_skip)
    if not n:
        # found-but-all-skipped is a DATA problem (reported above, file by
        # file) — claiming no CSVs exist would send the operator chasing a
        # path/glob phantom instead
        if skipped:
            sys.exit(f'error: all {len(skipped)} finalized CSV(s) under '
                     f'{args.dir_results} were skipped (reasons above); '
                     f'nothing trimmed')
        sys.exit(f'error: no finalized *_buzzdetect.csv under '
                 f'{args.dir_results}')
    ratio = before / after if after else float('inf')
    note = ('' if ratio >= 1 else
            ' (EXPANDED: container overhead exceeds these small CSVs — '
            'trimming pays off on hours-long recordings)')
    print(f'trimmed {n} file(s): {before:,} -> {after:,} bytes '
          f'({ratio:.1f}:1){note}')


if __name__ == '__main__':
    main()
