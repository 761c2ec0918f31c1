"""Quickstart: synthesize a minute of 'field audio', analyze it, and print
the strongest class per frame.

Counterpart of ``examples/quickstart.py``. Edits: it runs as a module and
analyzes on ``--device`` (the card unless told ``cpu``).

    python -m buzzdetect_torch.examples.quickstart [--device cpu]
"""

import argparse
import os
import tempfile
import wave

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    args = ap.parse_args(argv)

    from buzzdetect_torch.models.classifier import resolve_device
    resolve_device(args.device)   # CUDA without a card raises here

    from buzzdetect_torch import analyze
    from buzzdetect_torch.write.detections import call_detections_directory
    from buzzdetect_torch.write.trim import read_results

    with tempfile.TemporaryDirectory() as td:
        dir_audio = os.path.join(td, 'audio')
        os.makedirs(dir_audio)

        # a minute of "field recording": ambient noise with a buzzy segment
        rate = 16000
        t = np.arange(60 * rate) / rate
        x = 0.02 * np.random.default_rng(0).standard_normal(len(t))
        buzz = (20 <= t) & (t < 25)
        x[buzz] += sum(0.15 / k * np.sin(2 * np.pi * 220 * k * t[buzz])
                       for k in (1, 2, 3))
        with wave.open(os.path.join(dir_audio, 'field.wav'), 'wb') as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(rate)
            w.writeframes((np.clip(x, -1, 1) * 32767).astype('<i2').tobytes())

        dir_out = os.path.join(td, 'results')
        analyze(modelname='model_general_v3', dir_audio=dir_audio,
                dir_out=dir_out, verbosity_print='WARNING',
                device=args.device)

        starts, cols = read_results(
            os.path.join(dir_out, 'field_buzzdetect.csv'))
        names = list(cols)
        scores = np.stack([cols[n] for n in names], axis=1)
        print(f'\nanalyzed on {args.device}')
        print('frame  strongest class            activation')
        for i in range(0, len(starts), 5):
            j = scores[i].argmax()
            print(f'{starts[i]:5.1f}s  {names[j]:<26s} {scores[i, j]:+.2f}')

        # the archival workflow: threshold the stored activations AFTER
        # the fact and coalesce detected frames into events — re-callable
        # at any threshold without re-analysis
        events = call_detections_directory(dir_out, threshold=-2.0)
        print(f'\n{len(events)} ins_buzz event(s) at threshold -2.0:')
        for e in events:
            print(f"  {e['ident']}: {e['start']:.2f}-{e['end']:.2f}s "
                  f"(peak {e['activation_max']:+.2f})")
        return starts, scores, events


if __name__ == '__main__':
    main()
