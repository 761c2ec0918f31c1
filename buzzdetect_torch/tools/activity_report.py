"""Buzz activity over wall-clock time, straight from archived results.

The "sounds to stats" step: threshold the archived activations into
events (same engine as buzzdetect_torch.tools.call_detections), recover each
recording's start time from its filename (AudioMoth/SongMeter-style
fixed-width timestamps, e.g. ``HIVE3_20240601_123000.wav``), and
aggregate detected seconds + event counts into hourly or daily bins —
the table a field study actually reports. Optionally renders an SVG
activity chart.

Usage:
    python -m buzzdetect_torch.tools.activity_report \
        --dir_results ./out --threshold -1.2
    python -m buzzdetect_torch.tools.activity_report \
        --dir_results ./out --precision 0.95 \
        --bin day --out activity.csv --plot activity.svg

Counterpart of ``tools/activity_report.py`` on the port; ``main`` takes
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
    ap.add_argument('--modelname', default=None)
    ap.add_argument('--classes', nargs='+', default=['ins_buzz'])
    ap.add_argument('--merge_gap', type=float, default=None)
    ap.add_argument('--timestamp_format', default='%Y%m%d_%H%M%S',
                    help='strptime pattern embedded (fixed-width) in the '
                         'recording filenames (default: AudioMoth style '
                         '%%Y%%m%%d_%%H%%M%%S)')
    ap.add_argument('--bin', default='hour',
                    help="bin width: 'hour', 'day', or seconds")
    ap.add_argument('--allow_missing', action='store_true',
                    help='skip recordings whose filename has no parseable '
                         'timestamp instead of failing')
    ap.add_argument('--out', default=None, help='write the table as CSV')
    ap.add_argument('--plot', default=None,
                    help='render an SVG activity chart here')
    args = ap.parse_args(argv)

    try:
        bin_s = {'hour': 3600.0, 'day': 86400.0}.get(
            args.bin) or float(args.bin)
    except ValueError:
        ap.error(f"--bin must be 'hour', 'day', or seconds "
                 f"(got {args.bin!r})")
    if bin_s <= 0:
        ap.error(f'--bin must be positive (got {args.bin!r})')
    check_calibration_args(ap, args)

    from buzzdetect_torch.write.activity import (parse_ident_timestamp,
                                                 bin_events,
                                                 render_activity_csv)
    from buzzdetect_torch.write.detections import call_detections_directory

    rows = call_detections_directory(
        args.dir_results, threshold=args.threshold,
        precision=args.precision, recall=args.recall,
        modelname=args.modelname,
        classes=args.classes, merge_gap_s=args.merge_gap,
        on_skip=lambda path, why: print(f'skipping {path}: {why}',
                                        file=sys.stderr))
    idents = sorted({r['ident'] for r in rows})
    starts = {i: parse_ident_timestamp(i, args.timestamp_format)
              for i in idents}
    unparsed = sorted(i for i, t in starts.items() if t is None)
    if unparsed:
        msg = (f'{len(unparsed)} recording name(s) carry no '
               f'{args.timestamp_format!r} timestamp: '
               f'{", ".join(unparsed[:5])}'
               + (' ...' if len(unparsed) > 5 else ''))
        if not args.allow_missing:
            sys.exit(f'error: {msg}\n(pass --timestamp_format matching '
                     f'your recorder naming, or --allow_missing to skip)')
        print(f'warning: {msg} — skipped', file=sys.stderr)
        rows = [r for r in rows if starts[r['ident']] is not None]
    starts = {i: t for i, t in starts.items() if t is not None}

    binned = bin_events(rows, starts, bin_s=bin_s)
    print(f'{len(rows)} event(s) across {len(starts)} recording(s) '
          f'-> {len(binned)} non-empty (bin, class) cell(s)')
    for (b, cls), cell in sorted(binned.items()):
        print(f"  {b:%Y-%m-%d %H:%M}  {cls:<14s} "
              f"{cell['n_events']:3d} events  "
              f"{cell['seconds']:8.1f} s detected")

    if args.out:
        render_activity_csv(binned, args.out)
        print(f'wrote {args.out}')
    if args.plot:
        _plot(binned, bin_s, args.plot)
        print(f'wrote {args.plot}')


def _plot(binned, bin_s, path):
    """Detected seconds per bin, one bar series per class (reuses the
    training-report matplotlib style)."""
    from buzzdetect_torch.train.report import _plt, _style, _save
    plt = _plt()
    classes = sorted({cls for _, cls in binned})
    bins = sorted({b for b, _ in binned})
    fig, ax = plt.subplots(figsize=(max(6, len(bins) * 0.5), 3.5))
    width = 0.8 / max(1, len(classes))
    for k, cls in enumerate(classes):
        xs = range(len(bins))
        ys = [binned.get((b, cls), {'seconds': 0.0})['seconds']
              for b in bins]
        ax.bar([x + k * width for x in xs], ys, width=width, label=cls)
    ax.set_xticks([x + 0.4 for x in range(len(bins))])
    fmt = '%m-%d %H:%M' if bin_s < 86400 else '%Y-%m-%d'
    ax.set_xticklabels([b.strftime(fmt) for b in bins],
                       rotation=45, ha='right', fontsize=7)
    ax.set_ylabel('detected seconds')
    ax.legend(fontsize=7)
    _style(ax)
    _save(fig, path)


if __name__ == '__main__':
    main()
