"""Embed an audio corpus once; iterate on model heads for free.

The expensive half of analysis is decode + the YAMNet CNN; the head is a
1024xC matmul. This tool runs the expensive half ONCE over a directory,
writing one ``<ident>_embeddings.npz`` (frame-start grid + 1024-d
embeddings) per recording — the cache that ``score_embeddings`` rescores
with any head, that ``train_model`` trains from, and that
``build_ensemble`` members share. Resumable like analysis:
rerunning skips finished files; a manifest pins the embedder + framehop
so a rerun with different settings fails loudly instead of silently
mixing frame grids.

(Reference parity note: the reference ships its training corpus already
embedded — see SURVEY.md §2a "model metadata/eval artifacts" — but no
tool to produce such a cache; this closes the workflow's CLI loop:
embed_corpus -> train_model / score_embeddings -> call_detections ->
activity_report.)

Usage:
    python -m buzzdetect_torch.tools.embed_corpus \
        --dir_audio ./recordings --dir_out ./emb
    python -m buzzdetect_torch.tools.embed_corpus \
        --dir_audio ./recordings --dir_out ./emb \
        --framehop 0.5 --modelname model_general_v3

Counterpart of ``tools/embed_corpus.py`` on the port; ``main`` takes
``argv``.
"""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('--dir_audio', required=True,
                    help='directory of recordings (any supported codec), '
                         'or a single audio file')
    ap.add_argument('--dir_out', required=True,
                    help='embeddings cache directory (one npz per '
                         'recording + embeddings_manifest.json)')
    ap.add_argument('--modelname', default=None,
                    help='model whose embedder (and framehop grid) to use '
                         '(default: the default model)')
    ap.add_argument('--framehop', type=float, default=1.0,
                    help='frame hop as a proportion of the frame length '
                         '(matches analyze(framehop_prop=); default 1.0)')
    ap.add_argument('--chunklength', type=float, default=200.0,
                    help='seconds of audio per device dispatch')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                    help='the device that embeds (default: the card)')
    args = ap.parse_args(argv)

    from buzzdetect_torch.validation import (validate_chunklength,
                                             validate_framehop)
    v = validate_framehop(args.framehop)
    if not v.valid:
        ap.error(f'--framehop: {v.message}')
    if v.message:
        # valid-with-warning (framehop > 1 leaves unsampled gaps) — print
        # it like the main CLI does instead of discarding it
        print(f'warning: --framehop: {v.message}', file=sys.stderr)
    v = validate_chunklength(args.chunklength)
    if not v.valid:
        ap.error(f'--chunklength: {v.message}')

    from buzzdetect_torch.train.embed_corpus import embed_directory
    try:
        written = embed_directory(
            args.dir_audio, args.dir_out, modelname=args.modelname,
            framehop_prop=args.framehop, chunklength=args.chunklength,
            device=args.device)
    except ValueError as e:
        sys.exit(f'error: {e}')
    print(f'embedded {len(written)} new file(s) -> {args.dir_out} '
          f'(rerun resumes; score with '
          f'buzzdetect_torch.tools.score_embeddings)')


if __name__ == '__main__':
    main()
