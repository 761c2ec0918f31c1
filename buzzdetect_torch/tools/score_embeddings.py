"""Score cached embeddings with any model head — no re-decode, no re-embed.

The model-iteration workflow: embedding a season of audio costs hours;
the classifier head is a 1024xC matmul that costs nothing. Embed the
corpus ONCE (`buzzdetect_torch.train.embed_corpus.embed_directory`, also
the training pipeline's first step), then score it with every candidate
head — a retrained model, an imported reference head, an ensemble —
producing standard result CSVs (`<ident>_buzzdetect.csv`, schema
identical to a full analyze() run) in seconds per iteration.

Usage:
    python -m buzzdetect_torch.tools.score_embeddings \
        --dir_embeddings ./emb \
        --modelname my_model_v2 --dir_out ./results_v2
    python -m buzzdetect_torch.tools.score_embeddings \
        --dir_embeddings ./emb \
        --modelname my_model_v2 --precision 0.95 --dir_out ./detections_v2

Counterpart of ``tools/score_embeddings.py`` on the port; ``main`` takes
``argv``. The head runs on ``--device`` (the card unless ``cpu`` is
given), as it does inside ``analyze()``.
"""

import argparse
import json
import os
import sys

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--dir_embeddings', required=True,
                    help='directory of <ident>_embeddings.npz + '
                         'embeddings_manifest.json (embed_directory output)')
    ap.add_argument('--modelname', required=True,
                    help='model whose head scores the embeddings')
    ap.add_argument('--dir_out', required=True)
    ap.add_argument('--classes_out', nargs='+', default=['all'])
    ap.add_argument('--precision', type=float, default=None,
                    help='detections mode at this calibrated precision '
                         '(default: archive activations)')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                    help='the device that runs the head (default: the '
                         'card)')
    args = ap.parse_args(argv)

    import torch

    from buzzdetect_torch import config as cfg
    from buzzdetect_torch.models.classifier import resolve_device
    from buzzdetect_torch.ops.sepconv import exact_f32
    from buzzdetect_torch.models.heads import apply_head
    from buzzdetect_torch.write.formatting import (format_activations,
                                                   format_detections)
    from buzzdetect_torch.write.thresholds import calculate_threshold

    # --- the embeddings' provenance pin -------------------------------------
    path_manifest = os.path.join(args.dir_embeddings,
                                 'embeddings_manifest.json')
    if not os.path.exists(path_manifest):
        sys.exit(f'error: {args.dir_embeddings} has no '
                 f'embeddings_manifest.json — score only embeddings written '
                 f'by embed_directory (the manifest pins the embedder and '
                 f'framehop these frame grids were computed with)')
    with open(path_manifest) as f:
        emb_manifest = json.load(f)

    # --- the head ------------------------------------------------------------
    dir_model = os.path.join(cfg.resolve_dir(cfg.DIR_MODELS), args.modelname)
    with open(os.path.join(dir_model, 'config_model.json')) as f:
        config = json.load(f)
    bundle = np.load(os.path.join(dir_model, 'model.npz'))
    if 'head/kernel' not in bundle.files:
        sys.exit(f'error: model {args.modelname} is not an npz bundle with '
                 f'a linear head; score_embeddings needs head/kernel')
    device = resolve_device(args.device)
    exact_f32()
    params = {k: torch.from_numpy(np.asarray(bundle[k], np.float32)).to(
        device) for k in ('head/kernel', 'head/bias')}
    classes = list(config['classes'])
    digits_time = int(config.get('digits_time', 2))
    digits_results = int(config.get('digits_results', 2))

    emb_of = emb_manifest.get('model')
    if emb_of and emb_of != args.modelname:
        # heads only transfer within one embedding space; warn (don't block:
        # the ident may be a retrained sibling sharing the same embedder).
        # Config key is 'embeddername' (models/convert.py:216) — an earlier
        # 'embedder' lookup was always None, silencing this warning forever
        print(f'note: embeddings were extracted via model {emb_of!r}; '
              f'scoring with {args.modelname!r} assumes both use the same '
              f'embedder ({config.get("embeddername", "yamnet")})',
              file=sys.stderr)

    threshold = None
    if args.precision is not None:
        threshold = calculate_threshold(args.modelname, args.precision)
        print(f'precision {args.precision} -> threshold {threshold}')

    if args.classes_out == ['all']:
        keep = list(range(len(classes)))
    else:
        bad = [c for c in args.classes_out if c not in classes]
        if bad:
            sys.exit(f'error: classes_out {bad} not in model classes '
                     f'{classes}')
        # MODEL order, like format_activations' subset (write/formatting.py)
        # — user-given order or duplicates would break the byte-identity
        # with analyze() the tool promises
        wanted = set(args.classes_out)
        keep = [i for i, c in enumerate(classes) if c in wanted]

    # --- the result dir's manifest guard, BEFORE writing anything ------------
    # same order as analyze() (_check_manifest runs before the writer
    # starts): rescoring into a directory holding results from different
    # settings must refuse up front, not overwrite the stored manifest
    # after interleaving incompatible files — and a mid-run abort must not
    # leave finished CSVs with no manifest at all
    from buzzdetect_torch.manifest import (build_manifest,
                                           check_or_write_manifest)
    ok, why = check_or_write_manifest(args.dir_out, build_manifest(
        modelname=args.modelname,
        classes_out=[classes[i] for i in keep],  # resolved, like analyze()
        precision=args.precision,
        framehop_prop=emb_manifest.get('framehop_prop', 1.0)))
    if not ok:
        sys.exit(f'error: {why}')

    # --- score every cached file ---------------------------------------------
    from buzzdetect_torch.train.embed_corpus import SUFFIX_EMBEDDINGS
    paths = sorted(
        os.path.join(root, f)
        for root, _dirs, files in os.walk(args.dir_embeddings)
        for f in files if f.endswith(SUFFIX_EMBEDDINGS))
    if not paths:
        sys.exit(f'error: no *{SUFFIX_EMBEDDINGS} under '
                 f'{args.dir_embeddings}')

    n_frames = 0
    for path in paths:
        with np.load(path) as z:
            starts, emb = z['starts'], z['embeddings']
        if emb.shape[1] != params['head/kernel'].shape[0]:
            sys.exit(f'error: {os.path.basename(path)} embeddings are '
                     f'{emb.shape[1]}-d but the head expects '
                     f"{params['head/kernel'].shape[0]}-d — different "
                     f'embedder')
        with torch.inference_mode():
            scores = apply_head(params, torch.from_numpy(
                np.asarray(emb, np.float32)).to(device)).cpu().numpy()
        rel = os.path.relpath(path, args.dir_embeddings)
        ident = rel[:-len(SUFFIX_EMBEDDINGS)].replace(os.sep, '/')
        # byte parity with analyze() is structural, not mirrored: the SAME
        # formatting functions the writer uses produce the values/columns
        # (rounding, class subset, detections threshold); only the frame
        # grid is substituted — these frames carry the cache's absolute
        # starts, not the 0-based framehop grid add_time would derive
        if threshold is None:
            table = format_activations(
                scores, classes, framehop_s=0.0, digits_time=digits_time,
                classes_keep=('all' if args.classes_out == ['all']
                              else set(args.classes_out)),
                digits_results=digits_results)
        else:
            table = format_detections(scores, threshold, classes,
                                      framehop_s=0.0,
                                      digits_time=digits_time)
        table.start = np.round(starts, digits_time)
        path_out = os.path.join(args.dir_out,
                                ident + cfg.SUFFIX_RESULT_COMPLETE)
        os.makedirs(os.path.dirname(path_out) or '.', exist_ok=True)
        with open(path_out, 'w', newline='') as f:
            # finalized result files use CSV-dialect CRLF line endings
            # (runtime/writer.py finalize_partial's csv.writer default);
            # match byte-for-byte so rescored == analyzed
            f.write(table.render_csv(digits_time, include_header=True)
                    .replace('\n', '\r\n'))
        n_frames += len(starts)

    print(f'scored {n_frames} frames across {len(paths)} file(s) '
          f'-> {args.dir_out}')


if __name__ == '__main__':
    main()
