"""Build this repo's model_general_v3 bundle from available artifacts.

Sources (the embedder optional, with a deterministic seeded fallback):
* classifier head: the reference SavedModel variables checkpoint
  (``<reference>/models/model_general_v3/variables/variables``, read
  with tensorflow);
* evaluation metrics: the reference's 578-row threshold/precision table;
* YAMNet embedder weights: the public AudioSet `yamnet.h5` if a path is
  given (the mounted reference snapshot lacks the blob — see
  reference `.MISSING_LARGE_BLOBS`; URL recorded at
  reference `embedders/yamnet/BUILD.py:11`).

Usage:
    python -m buzzdetect_torch.tools.import_reference_model \
        --reference DIR [--yamnet-h5 PATH] [--out DIR]

Counterpart of ``tools/import_reference_model.py`` on the port; ``main``
takes ``argv``. ``--reference`` (a checkout of the reference repository)
has no default here: it is needed unless ``--card-only`` is given.
"""

import argparse
import os

CLASSES_V3 = [
    'mech_train', 'ins_trill', 'frog', 'ambient_noise', 'mech_plane',
    'ambient_rain', 'mech_hum', 'mech_auto', 'ins_buzz', 'mech_siren',
    'ambient_background', 'bird_goose', 'human',
]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--reference', default=None,
                    help='checkout of the reference repository (needed '
                         'unless --card-only)')
    ap.add_argument('--yamnet-h5', default=None)
    ap.add_argument('--out', default=None)
    ap.add_argument('--card-only', action='store_true',
                    help='leave model.npz untouched; only (re)write the '
                         'tests/ model card from the bundled metrics')
    args = ap.parse_args(argv)
    if args.reference is None and not args.card_only:
        ap.error('--reference is required unless --card-only is given')

    from buzzdetect_torch import config as cfg
    from buzzdetect_torch.models.convert import (build_model_bundle,
                                                 load_bundle)

    out = args.out or os.path.join(cfg.DIR_REPO, 'models',
                                   'model_general_v3')
    if args.card_only:
        arrays, config = load_bundle(out)
    else:
        ref_model = os.path.join(args.reference, 'models',
                                 'model_general_v3')
        head_prefix = os.path.join(ref_model, 'variables', 'variables')
        metrics_csv = os.path.join(ref_model, 'tests', 'metrics.csv')

        arrays, config = build_model_bundle(
            out,
            classes=CLASSES_V3,
            yamnet_h5=args.yamnet_h5,
            head_checkpoint_prefix=head_prefix,
            metrics_csv=metrics_csv,
            embeddername='yamnet',
            digits_results=2,
            provenance='model_general_v3 capability bundle',
        )
        print(f'wrote {out}/model.npz ({len(arrays)} arrays)')
        print(f'provenance: {config["provenance"]}')

    # model card: the reference distributes each model with its evaluation
    # report (reference models/model_general_v3/tests/); rebuild the pieces
    # the imported metrics table supports. NOTE the table describes the
    # REFERENCE's trained model (provenance records this) — it is the
    # calibration data the bundle actually ships, so the card renders it.
    metrics = {k[len('metrics_'):]: v for k, v in arrays.items()
               if k.startswith('metrics_')}
    if metrics:
        from buzzdetect_torch.train.evaluate import write_metrics_csv
        path = write_metrics_csv(
            os.path.join(out, 'tests', 'metrics.csv'), metrics)
        print(f'wrote {path} ({len(metrics["threshold"])} rows)')
        try:
            from buzzdetect_torch.train.report import plot_metrics
            path = plot_metrics(os.path.join(out, 'tests', 'metrics.svg'),
                                metrics)
            print(f'wrote {path}')
        except ImportError as e:
            print(f'skipping metrics.svg: {e}')


if __name__ == '__main__':
    main()
