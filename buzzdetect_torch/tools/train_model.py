"""Train a new buzzdetect model end-to-end: labeled audio corpus -> bundle.

The complete offline loop the reference ecosystem implies but never shipped:

    1. embed the corpus (streaming decode -> fused embed graph);
    2. turn event annotations into per-frame multi-hot labels
       (overlap rule, label translation);
    3. fine-tune a dense head (Adam + weighted BCE);
    4. evaluate on a held-out split -> threshold/precision/sensitivity/fpr;
    5. write a ready-to-analyze model directory (model.npz +
       config_model.json with bundled metrics).

Usage:
  python -m buzzdetect_torch.tools.train_model --name my_model \
      --dir-audio ./corpus --annotations ./events.csv \
      --classes ins_buzz ambient_noise human [--translation translation.csv]

Counterpart of ``tools/train_model.py`` on the port; ``main`` takes
``argv``. Every stage that runs the model runs on ``--device`` (the card
unless ``cpu`` is given), and each stage's wall time is printed after it.
"""

import argparse
import os
import time

import numpy as np


class _Stages:
    """Prints each stage's heading, and its wall time once the next stage
    begins (or ``end`` is called)."""

    def __init__(self, n):
        self.n, self.i, self.t0 = n, 0, None

    def __call__(self, text):
        self.end()
        self.i += 1
        print(f'[{self.i}/{self.n}] {text} ...', flush=True)
        self.t0 = time.perf_counter()

    def end(self):
        if self.t0 is not None:
            print(f'      ({time.perf_counter() - self.t0:.2f} s)',
                  flush=True)
            self.t0 = None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--name', required=True)
    ap.add_argument('--dir-audio', required=True)
    ap.add_argument('--annotations', required=True,
                    help='CSV: ident,start,end,label')
    ap.add_argument('--classes', nargs='+', required=True)
    ap.add_argument('--translation', default=None)
    ap.add_argument('--base-model', default=None,
                    help='model whose embedder weights to reuse '
                         '(default: the default model)')
    ap.add_argument('--framehop', type=float, default=1.0)
    ap.add_argument('--overlap-prop', type=float, default=0.2)
    ap.add_argument('--epochs', type=int, default=20)
    ap.add_argument('--learning-rate', type=float, default=1e-3)
    ap.add_argument('--target-class', default='ins_buzz',
                    help='class whose threshold/precision curve the metrics '
                         'table calibrates (runtime detections mode '
                         'thresholds ins_buzz specifically)')
    ap.add_argument('--holdout', type=float, default=0.2,
                    help='fraction of files held out for evaluation')
    ap.add_argument('--full', action='store_true',
                    help='fine-tune the WHOLE embedder on labeled clips '
                         '(default: head-only on frozen embeddings)')
    ap.add_argument('--augment', action='store_true',
                    help='with --full: on-device augmentation (gain/shift, '
                         'mixup, SpecAugment masks) inside the train step '
                         '— the standard small-corpus regularizers')
    ap.add_argument('--checkpoint-every', type=int, default=1,
                    help='with --full: persist the training state to the '
                         'work dir every N epochs; an interrupted run '
                         'resumes from it (bit-identical to uninterrupted)')
    ap.add_argument('--negatives-per-positive', type=float, default=1.0)
    ap.add_argument('--dir-work', default=None,
                    help='where embeddings are cached (default: <out>/work)')
    ap.add_argument('--out', default=None)
    ap.add_argument('--no-report', action='store_true',
                    help='skip the model-card artifacts (loss_curves.svg, '
                         'tests/*.svg, history.json)')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                    help='the device that embeds and trains (default: the '
                         'card)')
    args = ap.parse_args(argv)
    if args.augment and not args.full:
        # head-only training never reads --augment; silently proceeding
        # unaugmented would defeat the reason the flag was passed
        ap.error('--augment requires --full (augmentation happens inside '
                 'the full-model train step; head-only training runs on '
                 'frozen cached embeddings)')

    from buzzdetect_torch import config as cfg
    from buzzdetect_torch.models.convert import load_bundle, save_bundle
    from buzzdetect_torch.train.annotations import (load_events,
                                                    frames_to_labels)
    from buzzdetect_torch.train.data import load_translation
    from buzzdetect_torch.train.embed_corpus import (embed_directory,
                                                     load_embeddings,
                                                     SUFFIX_EMBEDDINGS)
    from buzzdetect_torch.train.evaluate import threshold_sweep
    from buzzdetect_torch.train.trainer import train_head
    from buzzdetect_torch.utils import build_ident

    out = args.out or os.path.join(cfg.resolve_dir(cfg.DIR_MODELS), args.name)
    dir_work = args.dir_work or os.path.join(out, 'work')
    base = args.base_model or cfg.DEFAULT_MODEL

    if args.full:
        # full-model path: clips -> end-to-end fine-tune -> bundle
        from buzzdetect_torch.train.clips import (build_clip_dataset,
                                                  train_full_model)
        events = load_events(args.annotations)
        translation = load_translation(args.translation) \
            if args.translation else None
        stage = _Stages(3)
        stage('extracting labeled clips')
        clips, labels = build_clip_dataset(
            args.dir_audio, events, args.classes, translation=translation,
            negatives_per_positive=args.negatives_per_positive)
        if not len(clips):
            raise SystemExit('no clips extracted — check the annotations')
        print(f'      {len(clips)} clips, {int(labels.sum())} positive labels')
        stage('fine-tuning embedder + head')
        raw, head, losses = train_full_model(
            clips, labels, epochs=args.epochs,
            learning_rate=args.learning_rate,
            framehop_prop=args.framehop,
            checkpoint_dir=dir_work,
            checkpoint_every=args.checkpoint_every,
            augment=args.augment, device=args.device)
        print(f'      loss {losses[0]:.4f} -> {losses[-1]:.4f}')
        stage('writing bundle')
        arrays = {f'yamnet_raw/{k}': v for k, v in raw.items()}
        arrays.update(head)
        config = {
            'classes': list(args.classes),
            'embeddername': 'yamnet',
            'digits_results': 2,
            'n_embeddings': 1024,
            'provenance': (f'full fine-tune by buzzdetect_torch.tools.'
                           f'train_model --full '
                           f'from {args.annotations} over {args.dir_audio}'),
        }
        save_bundle(out, arrays, config)
        _write_report(args, out, losses)
        stage.end()
        print(f'wrote {out}')
        return

    stage = _Stages(5)
    stage(f'embedding corpus {args.dir_audio}')
    embed_directory(args.dir_audio, dir_work, modelname=base,
                    framehop_prop=args.framehop, device=args.device)

    stage('building frame labels')
    events = load_events(args.annotations)
    translation = load_translation(args.translation) if args.translation \
        else None
    framelength = 0.96

    per_file = []
    for root, _dirs, files in os.walk(dir_work):
        for f in sorted(files):
            if not f.endswith(SUFFIX_EMBEDDINGS):
                continue
            path = os.path.join(root, f)
            # derive the stripped stem from the one shared suffix constant
            # (build_ident removes the '.npz' extension; a separate
            # '_embeddings' literal would desynchronize from
            # SUFFIX_EMBEDDINGS and silently zero every label lookup)
            suffix_stem = os.path.splitext(SUFFIX_EMBEDDINGS)[0]
            ident = build_ident(path, dir_work)[:-len(suffix_stem)]
            starts, emb = load_embeddings(path)
            labels = frames_to_labels(starts, events.get(ident, []),
                                      args.classes, framelength=framelength,
                                      overlap_prop=args.overlap_prop,
                                      translation=translation)
            per_file.append((ident, emb, labels))
    if not per_file:
        raise SystemExit('no embeddings produced — is the corpus empty?')

    rng = np.random.default_rng(0)
    order = rng.permutation(len(per_file))
    if args.holdout <= 0 or len(per_file) < 2:
        n_hold = 0
    else:
        n_hold = min(len(per_file) - 1,
                     max(1, int(len(per_file) * args.holdout)))
    hold_idx = set(order[:n_hold].tolist())
    train_emb = np.concatenate([per_file[i][1] for i in range(len(per_file))
                                if i not in hold_idx])
    train_lab = np.concatenate([per_file[i][2] for i in range(len(per_file))
                                if i not in hold_idx])
    print(f'      {len(train_emb)} training frames, '
          f'{int(train_lab.sum())} positive labels, '
          f'{n_hold} held-out files')

    stage('training head')
    head, losses = train_head(train_emb, train_lab, epochs=args.epochs,
                              batch_size=min(1024, len(train_emb)),
                              learning_rate=args.learning_rate,
                              device=args.device)
    print(f'      loss {losses[0]:.4f} -> {losses[-1]:.4f}')

    stage('evaluating')
    metrics = eval_scores = eval_labels = None
    if not n_hold:
        print('      skipping metrics: no held-out files (--holdout 0 or '
              'too few files); the bundle will not support '
              'precision-calibrated detections')
    elif args.target_class not in args.classes:
        print(f'      skipping metrics: target class '
              f'"{args.target_class}" is not in --classes (pass '
              f'--target-class to calibrate another); the bundle will not '
              f'support precision-calibrated detections')
    if n_hold and args.target_class in args.classes:
        hold_emb = np.concatenate([per_file[i][1] for i in hold_idx])
        hold_lab = np.concatenate([per_file[i][2] for i in hold_idx])
        ci = args.classes.index(args.target_class)
        scores = hold_emb @ head['head/kernel'] + head['head/bias']
        eval_scores, eval_labels = scores[:, ci], hold_lab
        try:
            metrics = threshold_sweep(scores[:, ci], hold_lab[:, ci])
            print(f'      {len(metrics["threshold"])} threshold rows')
        except ValueError as e:
            # one-sided holdout (random split can land only-negative files):
            # ship the bundle without metrics rather than with nonsense ones
            print(f'      WARNING: no metrics table — {e}')

    stage('writing bundle')
    base_arrays, _cfg = load_bundle(
        os.path.join(cfg.resolve_dir(cfg.DIR_MODELS), base))
    arrays = {k: v for k, v in base_arrays.items()
              if k.startswith(('yamnet/', 'yamnet_raw/'))}
    arrays.update(head)
    if metrics is not None:
        arrays.update({f'metrics_{k}': v for k, v in metrics.items()})
    config = {
        'classes': list(args.classes),
        'embeddername': 'yamnet',
        'digits_results': 2,
        'n_embeddings': 1024,
        'provenance': (f'trained by buzzdetect_torch.tools.train_model '
                       f'from {args.annotations} over {args.dir_audio}; '
                       f'embedder '
                       f'weights from {base}'),
    }
    save_bundle(out, arrays, config)
    _write_report(args, out, losses, metrics=metrics, scores=eval_scores,
                  labels=eval_labels)
    stage.end()
    print(f'wrote {out} — analyze with: buzzdetect-torch --modelname '
          f'{args.name} ...')


def _write_report(args, out, losses, metrics=None, scores=None, labels=None):
    """Model-card artifacts (loss curves, metric/activation plots) next to
    the bundle — the set the reference ships per model
    (reference models/model_general_v3/tests/)."""
    if args.no_report:
        return
    try:
        from buzzdetect_torch.train.report import write_model_report
        written = write_model_report(
            out, history={'loss': list(losses)}, metrics=metrics,
            scores=scores, labels=labels,
            classes=args.classes if scores is not None else None,
            target_class=args.target_class)
    except ImportError as e:  # no matplotlib: the bundle still works
        print(f'      skipping model card: {e}')
        return
    print(f'      model card: {len(written)} artifacts '
          f'({", ".join(sorted(os.path.basename(p) for p in written))})')


if __name__ == '__main__':
    main()
