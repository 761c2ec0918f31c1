"""Merge several model bundles sharing one embedder into a multi-head
ensemble bundle: one corpus pass scores every member's classes.

    python -m buzzdetect_torch.tools.build_ensemble \
        models/model_a models/model_b \
        --out models/ab_ensemble

See buzzdetect_torch.models.convert.build_ensemble_bundle for semantics
(identical embedder weights required; classes prefixed <member>.<class>).

Counterpart of ``tools/build_ensemble.py`` on the port; ``main`` takes
``argv``.
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('members', nargs='+',
                    help='member bundle directories (>= 2)')
    ap.add_argument('--out', required=True, help='output bundle directory')
    args = ap.parse_args(argv)

    from buzzdetect_torch.models.convert import build_ensemble_bundle
    _, config = build_ensemble_bundle(args.members, args.out)
    print(f'wrote ensemble bundle {args.out}: '
          f'{len(config["classes"])} classes '
          f'({config["provenance"]})')


if __name__ == '__main__':
    main()
