"""Command-line front-end: ``python -m buzzdetect_torch`` (installed as
``buzzdetect-torch``).

Copy of ``buzzdetect_tpu/cli.py`` (flag parity with the reference CLI,
`buzzdetect_cli.py:67-174`, including the interactive manifest-reconciliation
prompt on resume conflicts). Edits:

* imports from ``buzzdetect_torch``; ``--version`` reads the package's
  ``__version__``;
* ``--bf16`` maps to ``torch.bfloat16``: the CUDA conv kernels' bf16 mode;
* ``--device {cuda,cpu}`` (new; default ``cuda``): the counterpart of running
  the JAX CLI under ``JAX_PLATFORMS=cpu``;
* ``--devices`` counts the devices of ``--device``'s type (CUDA cards, or
  the one CPU); ``--host_shard I/N`` shards the corpus as the JAX CLI does;
* ``--strict_f32`` pins the conv kernels to exact f32 over a bundle's
  ``"conv_precision": "high"``;
* ``main`` returns None after a healthy end, as the JAX CLI does: the
  installed ``buzzdetect-torch`` script runs ``sys.exit(main())``, which
  exits 1 on any other value. An in-process caller that needs the
  Analyzer wraps ``buzzdetect_torch.analysis.analyze``.
"""

import argparse
import json
import os
import sys

from buzzdetect_torch import __version__
from buzzdetect_torch import config as cfg
from buzzdetect_torch.loglevels import loglevels
from buzzdetect_torch.manifest import (build_manifest, read_manifest,
                                       diff_manifests)


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ('yes', 'true', 't', 'y', '1'):
        return True
    if v.lower() in ('no', 'false', 'f', 'n', '0'):
        return False
    raise argparse.ArgumentTypeError('Boolean value expected.')


def _resolve_dir_out(dir_out, modelname):
    return cfg.resolve_dir_out(dir_out, modelname)


def _resolve_classes_out(modelname, classes_out):
    if classes_out != 'all':
        return classes_out
    path = os.path.join(cfg.resolve_dir(cfg.DIR_MODELS), modelname,
                        'config_model.json')
    with open(path) as f:
        return json.load(f)['classes']


def reconcile_with_manifest(modelname, dir_out, classes_out, precision,
                            framehop_prop, assume_yes=False):
    """If the output folder holds results from different settings, list the
    conflicts and offer to adopt the existing settings (exit on decline)."""
    existing = read_manifest(_resolve_dir_out(dir_out, modelname))
    if existing is None:
        return modelname, classes_out, precision, framehop_prop

    resolved = (_resolve_classes_out(modelname, classes_out)
                if precision is None else classes_out)
    candidate = build_manifest(modelname, framehop_prop, precision, resolved)
    conflicts = diff_manifests(existing, candidate)
    if not conflicts:
        return modelname, classes_out, precision, framehop_prop

    print('The output folder already contains results from different settings:')
    for c in conflicts:
        print(f'  - {c}')

    if assume_yes:
        resp = 'y'
    else:
        resp = input('\nAdopt the existing settings and continue? [y/N]: ')
        resp = resp.strip().lower()
    if resp not in ('y', 'yes'):
        print('Exiting without analyzing.')
        sys.exit(0)

    # .get fallbacks: a hand-edited manifest may lack keys — fall back to
    # this run's values rather than crash after the user already said yes
    if existing.get('output_mode') == 'detections':
        return (existing.get('modelname', modelname), 'all',
                existing.get('precision', precision),
                existing.get('framehop_prop', framehop_prop))
    return (existing.get('modelname', modelname),
            existing.get('classes_out', classes_out), None,
            existing.get('framehop_prop', framehop_prop))


def build_parser():
    parser = argparse.ArgumentParser(
        prog='buzzdetect',
        description='Analyze audio files using buzz detection machine '
                    'learning models for bioacoustics (PyTorch/CUDA)',
    )
    parser.add_argument('--version', action='version',
                        version=f'%(prog)s {__version__} (buzzdetect_torch)')
    parser.add_argument('--modelname', required=True, type=str,
                        help='Name of the model directory under models/')
    parser.add_argument('--classes_out', required=False, default='all',
                        type=str, nargs='+',
                        help='Class names to output ("all" for every class); '
                             'outputs raw activations')
    parser.add_argument('--precision', required=False, default=None, type=float,
                        help='Requested precision for binary buzz detections; '
                             'mutually exclusive with activation output')
    parser.add_argument('--framehop_prop', required=False, default=1,
                        type=float,
                        help='Frame stride as proportion of frame length '
                             '(1 = contiguous, 0.5 = half-overlap)')
    parser.add_argument('--chunklength', required=False, default=200,
                        type=float, help='Audio chunk length in seconds')
    parser.add_argument('--analyzers_cpu', required=False, default=1, type=int,
                        help='Number of parallel inference dispatch threads')
    parser.add_argument('--analyzers_gpu', required=False, default=0, type=int,
                        help='Additional inference dispatch threads (parity '
                             'flag; on TPU the sum is what matters)')
    parser.add_argument('--n_streamers', required=False, default=None, type=int,
                        help='Number of parallel audio decode threads')
    parser.add_argument('--stream_buffer_depth', required=False, default=None,
                        type=int, help='Chunks held in the prefetch ring')
    parser.add_argument('--dir_audio', required=False, default='./audio_in',
                        type=str, help='Directory containing audio to '
                                       'analyze, or a single audio file')
    parser.add_argument('--dir_out', required=False, default=None, type=str,
                        help='Output directory (default: model output subdir)')
    parser.add_argument('--verbosity_print', required=False, default='PROGRESS',
                        type=str, choices=list(loglevels))
    parser.add_argument('--verbosity_log', required=False, default='DEBUG',
                        type=str, choices=list(loglevels))
    parser.add_argument('--log_progress', required=False, default=False,
                        type=str2bool,
                        help='Write PROGRESS lines to the log file')
    parser.add_argument('--transfer_dtype', required=False, default=None,
                        choices=['float32', 'int16', 'mulaw'],
                        help='Host->device wire format for waveforms '
                             '(default int16; mulaw halves transfer bytes '
                             'for bandwidth-limited links)')
    parser.add_argument('--profile', required=False, default=None,
                        choices=['field', 'strict'],
                        help="One-flag deployment preset: 'field' = "
                             "throughput-first (mu-law wire; its "
                             "digital-silence caveat is logged and the "
                             "manifest records the profile), 'strict' = "
                             "bit-strict parity (float32 wire + exact-f32 "
                             "conv precision). Explicit knobs still win. "
                             "See docs/tuning.md 'Profiles'")
    parser.add_argument('--strict_f32', action='store_true',
                        help='Pin the conv products to exact f32 '
                             "(conv_precision 'highest'): on the CUDA conv "
                             "kernels it overrides a bundle's 'high' (the "
                             'emulated-HIGH mode); the XLA conv path '
                             "(\"conv\": \"xla\") runs exact f32 either way. "
                             'Ignored with --bf16')
    parser.add_argument('--resample_on_device', action='store_true',
                        help='Decode at native rate and resample on the '
                             'model\'s device ahead of the frontend (frees '
                             'host CPU; more wire bytes for rates >16kHz)')
    parser.add_argument('--devices', required=False, default=None,
                        help="Per-device replica data parallelism: an int N "
                             "(the first N devices of --device's type) or "
                             "'all'. Each device runs its own model replica "
                             "with its own dispatch thread on independent "
                             "chunks; results are identical to a "
                             "single-device run")
    parser.add_argument('--host_shard', required=False, default=None,
                        help="Multi-host run: 'I/N' (e.g. 0/4) analyzes only "
                             "this host's stable hash-assigned shard of the "
                             "corpus. Point every host at the same output "
                             "directory; they divide the work with no "
                             "coordination (completion state is the "
                             "filesystem)")
    parser.add_argument('--bf16', action='store_true',
                        help='Run the CNN in bfloat16 for throughput '
                             '(scores may deviate beyond 1e-3)')
    parser.add_argument('--device', required=False, default='cuda',
                        choices=['cuda', 'cpu'],
                        help="Where the model runs: 'cuda' (default; the "
                             "CUDA kernels on the card) or 'cpu' (every "
                             "kernel's plain PyTorch version)")
    parser.add_argument('--watch', action='store_true',
                        help='Live monitoring: keep rescanning dir_audio, '
                             'analyzing files that appear and the growing '
                             'tail of recordings in progress; Ctrl-C to stop '
                             '(finished work is always checkpointed)')
    parser.add_argument('--watch_interval', required=False, default=30.0,
                        type=float,
                        help='Seconds between rescans in --watch mode')
    parser.add_argument('--alert_classes', required=False, default=None,
                        nargs='+', metavar='CLASS',
                        help='Announce these classes live: log a WARNING '
                             'line the moment any frame exceeds the alert '
                             'threshold (pairs well with --watch)')
    parser.add_argument('--alert_threshold', required=False, default=None,
                        type=float,
                        help='Activation threshold for --alert_classes '
                             '(default: the --precision-calibrated '
                             'detection threshold)')
    parser.add_argument('--alert_command', required=False, default=None,
                        type=str,
                        help='Shell command run on each alert (event data '
                             'in BUZZ_CLASS/BUZZ_IDENT/BUZZ_AUDIO/'
                             'BUZZ_START/BUZZ_END/BUZZ_FRAMES/BUZZ_PEAK/'
                             'BUZZ_THRESHOLD env vars); non-blocking, '
                             'needs --alert_classes')
    parser.add_argument('--backend_timeout', required=False, default=None,
                        type=float,
                        help='Fail loudly if the device backend cannot '
                             'complete one dispatch within this many '
                             'seconds, instead of hanging forever on a '
                             'dead accelerator link (opt-in; costs a few '
                             'seconds of startup)')
    parser.add_argument('--stall_timeout', required=False, default=None,
                        type=float,
                        help='Stop the run (exit non-zero) if no chunk '
                             'completes for this many seconds mid-run — '
                             'a link that dies after startup otherwise '
                             'hangs silently. Safe: finished chunks are '
                             'checkpointed, a rerun resumes. Set well '
                             'above first-compile + one-chunk time '
                             '(>= 300 recommended)')
    parser.add_argument('--yes', action='store_true',
                        help='Answer yes to interactive prompts (resume '
                             'reconciliation)')
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)

    # one naming convention across every surface: the GUI form takes
    # comma-and/or-space separated class names (validation.split_names),
    # so the CLI's nargs tokens are re-split on commas too — otherwise
    # `--alert_classes a,b` silently becomes the single class 'a,b'
    from buzzdetect_torch.validation import (validate_map, split_names,
                                              watch_exempt)
    classes_out = args.classes_out
    if isinstance(classes_out, list):
        classes_out = [n for tok in classes_out for n in split_names(tok)]
        if classes_out == ['all']:
            classes_out = 'all'
    if isinstance(args.alert_classes, list):
        args.alert_classes = [n for tok in args.alert_classes
                              for n in split_names(tok)]

    # run the same per-field validators the GUI uses, so out-of-range
    # settings get a friendly message instead of a deep traceback
    values = {**vars(args), 'classes_out': classes_out}
    errors, warnings = [], []
    for name, rule in validate_map.items():
        if name not in values:
            continue
        if watch_exempt(name, args.watch):
            continue
        result = rule(values[name])
        if not result.valid:
            errors.append(f'--{name}: {result.message}')
        elif result.message:
            warnings.append(f'--{name}: {result.message}')
    if errors:
        parser.error('\n'.join(errors))
    for w in warnings:
        print(f'warning: {w}', file=sys.stderr)

    # Pin dir_out to the folder being RECONCILED before adoption can change
    # the modelname: with --dir_out unset, adopting a manifest recording a
    # different model would otherwise re-derive the default output folder
    # from the adopted name and write somewhere the user never reconciled.
    dir_out = _resolve_dir_out(args.dir_out, args.modelname)
    modelname, classes_out, precision, framehop_prop = reconcile_with_manifest(
        modelname=args.modelname, dir_out=dir_out,
        classes_out=classes_out, precision=args.precision,
        framehop_prop=args.framehop_prop, assume_yes=args.yes)

    compute_dtype = None
    if args.bf16:
        import torch
        compute_dtype = torch.bfloat16

    devices = args.devices
    if devices is not None:
        # same normalization as validate_devices ('All ' etc.) — the
        # validator's acceptance must be honored by the parse
        devices = str(devices).strip().lower()
        if devices != 'all':
            try:
                devices = int(devices)
            except ValueError:
                parser.error("--devices must be an integer or 'all'")
            if devices < 1:
                parser.error('--devices must be >= 1')

    host_shard = None
    if args.host_shard is not None:
        try:
            i, n = args.host_shard.split('/')
            host_shard = (int(i), int(n))
        except ValueError:
            parser.error("--host_shard must look like I/N, e.g. 0/4")
        if not 0 <= host_shard[0] < host_shard[1]:
            parser.error('--host_shard needs 0 <= I < N')

    from buzzdetect_torch.analysis import analyze
    result = analyze(modelname=modelname,
                     classes_out=classes_out,
                     precision=precision,
                     framehop_prop=framehop_prop,
                     chunklength=args.chunklength,
                     analyzers_cpu=args.analyzers_cpu,
                     analyzers_gpu=args.analyzers_gpu,
                     n_streamers=args.n_streamers,
                     stream_buffer_depth=args.stream_buffer_depth,
                     dir_audio=args.dir_audio,
                     dir_out=dir_out,
                     verbosity_print=args.verbosity_print,
                     verbosity_log=args.verbosity_log,
                     log_progress=args.log_progress,
                     compute_dtype=compute_dtype,
                     devices=devices,
                     host_shard=host_shard,
                     transfer_dtype=args.transfer_dtype,
                     strict_f32=args.strict_f32,
                     profile=args.profile,
                     resample_on_device=args.resample_on_device,
                     watch=args.watch,
                     watch_interval=args.watch_interval,
                     alert_classes=args.alert_classes,
                     alert_threshold=args.alert_threshold,
                     alert_command=args.alert_command,
                     backend_timeout=args.backend_timeout,
                     stall_timeout=args.stall_timeout,
                     device=args.device)

    # scripting contract: abnormal endings (fatal worker failure, device
    # stall, manifest mismatch, interrupts) must not exit 0 — field
    # supervisors and `buzzdetect ... && next_step` pipelines key off the
    # exit code. None = a pre-run path that never built a coordinator.
    from buzzdetect_torch.runtime.coordination import HEALTHY_END_REASONS
    reason = getattr(getattr(result, 'coordinator', None), 'end_reason',
                     None)
    if reason is not None and reason not in HEALTHY_END_REASONS:
        print(f'analysis ended abnormally: {reason}', file=sys.stderr)
        sys.exit(130 if reason == 'interrupted' else 1)


if __name__ == '__main__':
    main()
