"""AOT serving: export the classify graph once, then score chunks from the
serialized artifact alone — no weight bundle or tracing on the serving
host.

Counterpart of ``examples/serve_aot.py``. The artifact bakes the weights in
as buffers of a ``torch.export`` program at a fixed chunk shape and wire
dtype, so a serving process is just: load, feed wire-format buffers, read
score rows. Edits: it runs as a module, exports for ``('cpu', 'cuda')``
and serves on ``--device`` (the card unless told ``cpu``). A
``conv='pallas'`` artifact would also need ``buzzdetect_torch`` on the
serving host (``models/export.py``); this one, ``conv='xla'`` with the
matmul frontend, needs only torch to load.

    python -m buzzdetect_torch.examples.serve_aot [--device cpu]
"""

import argparse
import os
import tempfile

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    args = ap.parse_args(argv)

    from buzzdetect_torch.models.export import (export_classifier,
                                                save_exported, load_exported)
    from buzzdetect_torch.utils import quantize_int16

    # --- build side (once, anywhere) ------------------------------------
    # 60 s chunks on the int16 wire; platforms lists every device the
    # artifact must load on (('cpu', 'cuda') is the portable default)
    blob, meta = export_classifier('model_general_v3', chunk_seconds=60.0,
                                   platforms=('cpu', 'cuda'),
                                   transfer_dtype='int16')
    with tempfile.TemporaryDirectory() as td:
        d = save_exported(os.path.join(td, 'serving'), blob, meta)
        print(f'exported {len(blob) / 1e6:.1f} MB artifact -> {d}')
        print(f"  chunk: {meta['chunk_seconds']} s "
              f"({meta['input_samples']} samples {meta['input_dtype']}), "
              f"{meta['n_patches']} frames @ {meta['framehop_s']} s hop")

        # --- serving side (no model code needed beyond load_exported) ---
        call, meta = load_exported(d, device=args.device)
        rate = meta['samplerate']
        t = np.arange(meta['input_samples']) / rate
        x = 0.02 * np.random.default_rng(0).standard_normal(len(t))
        x[t < 5] += sum(0.15 / k * np.sin(2 * np.pi * 220 * k * t[t < 5])
                        for k in (1, 2, 3))  # a buzzy first 5 seconds
        scores = np.asarray(call(quantize_int16(x.astype(np.float32))))

        assert scores.shape == (meta['n_patches'], len(meta['classes']))
        top = np.argmax(scores, axis=1)
        print(f'scored {scores.shape[0]} frames on {args.device}; strongest '
              f'class of the first 5:')
        for i in range(5):
            t0 = i * meta['framehop_s']
            print(f'  {t0:6.2f}s  {meta["classes"][top[i]]:20s} '
                  f'{scores[i, top[i]]:+.2f}')


if __name__ == '__main__':
    main()
