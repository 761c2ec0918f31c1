"""AOT serving-artifact round trip on the card (or ``--device cpu``):
export the classify graph, serialize, reload, execute, and compare scores
against the live classifier.

Counterpart of ``tools/aot_tpu_probe.py``: the artifact must reproduce
live scores on the hardware it serves on, not just on the CPU the
round-trip test uses. The live comparator is built with the artifact's
``conv`` and ``conv_precision`` (the meta records them), so the comparison
measures the artifact's fidelity, not the difference between two conv
paths. Edits: ``--device`` picks the card or the CPU (the artifact is
exported for ``('cpu', 'cuda')``, or ``('cpu',)`` with ``--device cpu``),
and ``platform`` names ``torch.cuda.get_device_name``.

    python -m buzzdetect_torch.tools.aot_probe [--seconds 9.6] [--device cpu]
"""

import argparse
import json
import os
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--seconds', type=float, default=9.6)
    ap.add_argument('--modelname', default='model_general_v3')
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from buzzdetect_torch.models.export import (export_classifier,
                                                save_exported, load_exported)
    from buzzdetect_torch.models.registry import load_model

    platforms = {'cpu': ('cpu',), 'cuda': ('cpu', 'cuda')}[args.device]
    blob, meta = export_classifier(args.modelname,
                                   chunk_seconds=args.seconds,
                                   platforms=platforms,
                                   transfer_dtype='int16')
    with tempfile.TemporaryDirectory() as td:
        d = save_exported(os.path.join(td, 'serving'), blob, meta)
        call, meta2 = load_exported(d, device=args.device)
        model = load_model(args.modelname, initialize=True,
                           transfer_dtype='int16', conv=meta2['conv'],
                           conv_precision=meta2['conv_precision'],
                           device=args.device)
        rng = np.random.default_rng(0)
        wav = (rng.standard_normal(meta2['input_samples'])
               * 0.1).astype(np.float32)
        wire = model.classifier.to_wire(wav)
        aot = np.asarray(call(wire))[:meta2['n_patches']]
        live = model.classifier.predict(wire)
    diff = float(np.abs(aot - live).max())

    platform = (torch.cuda.get_device_name(model.device)
                if args.device == 'cuda' else 'cpu')
    print(json.dumps({
        'platform': f'{args.device} {platform}',
        'artifact_bytes': len(blob),
        'export_platforms': meta['platforms'],
        'n_patches': meta2['n_patches'],
        'max_abs_diff_aot_vs_live': diff,
        'ok': bool(diff <= 1e-4),
    }))
    return 0 if diff <= 1e-4 else 1


if __name__ == '__main__':
    raise SystemExit(main())
