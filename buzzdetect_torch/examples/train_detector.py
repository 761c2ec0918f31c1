"""Train a working detector from labeled audio, end to end.

Counterpart of ``examples/train_detector.py``. Synthesizes a labeled
corpus (buzzy tones vs ambient noise), runs the full training loop
(embed -> label -> train head -> holdout threshold sweep -> bundle with
packed metrics), then analyzes unseen recordings in detections mode at a
requested precision and prints what fired. Edits: it runs as a module on
``--device`` (the card unless told ``cpu``), and calls the training tool
(``buzzdetect_torch.tools.train_model``) in process rather than as a
child process, with the models folder set in ``config.DIR_MODELS``.

    python -m buzzdetect_torch.examples.train_detector [--device cpu]
"""

import argparse
import os
import tempfile
import wave

import numpy as np


def write_wav(path, data, rate=16000):
    ints = np.clip(np.round(data * 32768), -32768, 32767).astype('<i2')
    with wave.open(str(path), 'wb') as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(ints.tobytes())


def tone(seconds, freq, rate=16000):
    t = np.arange(int(seconds * rate)) / rate
    return sum((0.2 / k) * np.sin(2 * np.pi * freq * k * t)
               for k in (1, 2, 3)).astype(np.float32)


def noise(seconds, scale=0.1, rate=16000, seed=0):
    return (np.random.default_rng(seed).standard_normal(int(seconds * rate))
            * scale).astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    args = ap.parse_args(argv)

    from buzzdetect_torch.models.classifier import resolve_device
    resolve_device(args.device)   # CUDA without a card raises here

    from buzzdetect_torch import config as cfg
    from buzzdetect_torch.analysis import analyze
    from buzzdetect_torch.models.convert import build_model_bundle
    from buzzdetect_torch.tools import train_model
    from buzzdetect_torch.write.thresholds import calculate_threshold

    saved = cfg.DIR_MODELS
    with tempfile.TemporaryDirectory() as td:
        dir_models = os.path.join(td, 'models')
        dir_corpus = os.path.join(td, 'corpus')
        os.makedirs(dir_corpus)
        cfg.DIR_MODELS = dir_models
        try:
            # a base bundle supplies the embedder weights (use your real
            # pretrained bundle here; the seeded one still separates clean
            # classes, as this script demonstrates)
            build_model_bundle(os.path.join(dir_models, 'base'),
                               classes=['x'], seed=2)

            print('synthesizing labeled corpus ...')
            ann = ['ident,start,end,label']
            for i in range(8):
                write_wav(os.path.join(dir_corpus, f'buzz{i}.wav'),
                          tone(4.0, 200 + 10 * i) + noise(4.0, 0.02, seed=i))
                ann.append(f'buzz{i},0,4,ins_buzz')
            for i in range(8):
                write_wav(os.path.join(dir_corpus, f'amb{i}.wav'),
                          noise(4.0, seed=100 + i))
            path_ann = os.path.join(td, 'events.csv')
            with open(path_ann, 'w') as f:
                f.write('\n'.join(ann) + '\n')

            print(f'training on {args.device} (embed -> label -> head -> '
                  f'holdout metrics) ...')
            train_model.main(
                ['--name', 'demo_detector', '--dir-audio', dir_corpus,
                 '--annotations', path_ann,
                 '--classes', 'ins_buzz', 'ambient_background',
                 '--base-model', 'base', '--epochs', '400',
                 '--learning-rate', '0.01', '--holdout', '0.4',
                 '--dir-work', os.path.join(td, 'work'), '--no-report',
                 '--device', args.device])

            print('\nanalyzing unseen recordings in detections mode ...')
            dir_field = os.path.join(td, 'field')
            os.makedirs(dir_field)
            write_wav(os.path.join(dir_field, 'has_buzz.wav'),
                      tone(4.0, 231) + noise(4.0, 0.02, seed=55))
            write_wav(os.path.join(dir_field, 'no_buzz.wav'),
                      noise(4.0, seed=56))

            dir_out = os.path.join(td, 'out')
            analyze(modelname='demo_detector', dir_audio=dir_field,
                    dir_out=dir_out, chunklength=2.0, precision=0.95,
                    verbosity_print='ERROR', device=args.device)

            print(f'  calibrated threshold @ precision 0.95: '
                  f'{calculate_threshold("demo_detector", 0.95):.2f}')
            fired = {}
            for name in ('has_buzz', 'no_buzz'):
                with open(os.path.join(dir_out,
                                       f'{name}_buzzdetect.csv')) as f:
                    rows = f.read().splitlines()[1:]
                fired[name] = (sum(int(r.split(',')[1]) for r in rows),
                               len(rows))
                print(f'  {name}: {fired[name][0]}/{fired[name][1]} frames '
                      f'detected')
            print('(a requested precision of 0.95 tolerates occasional '
                  'false positives by design;\n raise it — or label more '
                  'holdout audio for a denser calibration curve — for '
                  'stricter detections)')
            return fired
        finally:
            cfg.DIR_MODELS = saved


if __name__ == '__main__':
    main()
