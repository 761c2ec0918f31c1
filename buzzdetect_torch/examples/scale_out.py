"""Every scale-out layout in one runnable script.

Counterpart of ``examples/scale_out.py``: the three ways a deployment
grows beyond one device, and that each gives the results of one device:

1. ``devices=N`` — per-device REPLICA data parallelism: each device runs
   its own model replica on independent chunks (zero collectives; the
   throughput-max layout for this ~3 M-param model).
2. ``mesh=...`` — each chunk's patch axis splits across the devices (the
   latency-min layout: one chunk finishes ~N x sooner).
3. ``host_shard=(i, n)`` — multi-HOST corpus sharding: each process
   analyzes only its stable hash-assigned shard, sharing one output
   directory with zero coordination (simulated here by running both
   "hosts" sequentially in one process; in production they are different
   machines).

Edits: it runs as a module on ``--device`` (the card unless told
``cpu``). Where only one device of that type is attached (one card, or
the CPU) the replicas and the mesh repeat it, and the script says so.
A mesh runs the XLA conv path (the hand conv kernels cannot be split, as
in the JAX package), so the meshed CSVs are held byte for byte to one
device on that path (a bundle variant whose config says ``"conv":
"xla"``), and to the default run, on the hand kernels, after the CSVs'
2-digit rounding (one unit of the last digit: a score within f32
rounding of a rounding edge may print the other way). The replicas and
the hosts are held byte for byte to the default run.

    python -m buzzdetect_torch.examples.scale_out [--device cpu]
"""

import argparse
import json
import os
import shutil
import tempfile

import numpy as np

MODEL = 'model_general_v3'
XLA_MODEL = 'model_general_v3_xla'


def _models_dir(root, src):
    """``root/models``: MODEL (its bundle linked) and XLA_MODEL, a copy
    whose config says ``"conv": "xla"``."""
    models = os.path.join(root, 'models')
    for name, extra in ((MODEL, {}), (XLA_MODEL, {'conv': 'xla'})):
        dst = os.path.join(models, name)
        shutil.copytree(src, dst, ignore=shutil.ignore_patterns('model.npz',
                                                                'output'))
        os.symlink(os.path.join(src, 'model.npz'),
                   os.path.join(dst, 'model.npz'))
        path = os.path.join(dst, 'config_model.json')
        with open(path) as f:
            config = json.load(f)
        with open(path, 'w') as f:
            json.dump({**config, **extra}, f)
    return models


def _csv(td, layout, i):
    with open(os.path.join(td, layout, f'rec{i}_buzzdetect.csv')) as f:
        return f.read()


def _table(text):
    return np.array([ln.split(',') for ln in text.splitlines()[1:]], float)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    args = ap.parse_args(argv)

    import torch
    from buzzdetect_torch import config as cfg
    from buzzdetect_torch.analysis import analyze
    from buzzdetect_torch.models.classifier import resolve_device
    from buzzdetect_torch.parallel import make_mesh
    from buzzdetect_torch.utils import write_wav

    resolve_device(args.device)   # CUDA without a card raises here
    n_attached = (torch.cuda.device_count() if args.device == 'cuda'
                  else 1)
    if n_attached > 1:
        devices = [f'cuda:{i}' for i in range(n_attached)]
        print(f'devices: {n_attached} x {args.device}')
    else:
        first = 'cuda:0' if args.device == 'cuda' else 'cpu'
        devices = [first] * 2
        print(f'devices: one {args.device} device attached, so the '
              f'replicas and the mesh below repeat it: {devices}')
    n_dev = len(devices)

    src = os.path.join(cfg.resolve_dir(cfg.DIR_MODELS), MODEL)
    saved = cfg.DIR_MODELS
    with tempfile.TemporaryDirectory(prefix='bz_scaleout_') as td:
        cfg.DIR_MODELS = _models_dir(td, src)
        try:
            dir_audio = os.path.join(td, 'audio')
            os.makedirs(dir_audio)
            rng = np.random.default_rng(0)
            for i in range(4):
                t = np.arange(int((3 + i) * 16000)) / 16000.0
                write_wav(os.path.join(dir_audio, f'rec{i}.wav'),
                          0.3 * np.sin(2 * np.pi * (200 + 60 * i) * t)
                          + 0.03 * rng.standard_normal(t.shape))

            common = dict(dir_audio=dir_audio, chunklength=2.0,
                          verbosity_print='ERROR', device=args.device)

            print('1/5  single device (the oracle)...')
            analyze(modelname=MODEL, dir_out=os.path.join(td, 'single'),
                    **common)

            print(f'2/5  {n_dev} per-device replicas (devices=...)...')
            analyze(modelname=MODEL, dir_out=os.path.join(td, 'replicas'),
                    devices=devices, **common)

            print('3/5  single device on the XLA conv path (the mesh\'s '
                  'oracle)...')
            analyze(modelname=XLA_MODEL,
                    dir_out=os.path.join(td, 'single_xla'), **common)

            print(f'4/5  {n_dev}-way patch sharding (mesh=...)...')
            analyze(modelname=MODEL, dir_out=os.path.join(td, 'meshed'),
                    mesh=make_mesh(devices=devices, device=args.device),
                    **common)

            print('5/5  two-host corpus sharding (host_shard=...)...')
            for host in range(2):
                analyze(modelname=MODEL, dir_out=os.path.join(td, 'hosts'),
                        host_shard=(host, 2), **common)

            worst = 0.0
            for layout, oracle in (('replicas', 'single'),
                                   ('meshed', 'single_xla'),
                                   ('hosts', 'single')):
                for i in range(4):
                    assert _csv(td, layout, i) == _csv(td, oracle, i), \
                        f'{layout} differs from {oracle} on rec{i}'
                print(f'{layout}: byte-identical to the {oracle} run, all '
                      f'4 files')
            for i in range(4):
                worst = max(worst, float(np.abs(
                    _table(_csv(td, 'meshed', i))
                    - _table(_csv(td, 'single', i))).max()))
            assert worst <= 0.0101, worst
            print(f'meshed against single (the hand kernels): max |d| = '
                  f'{worst:.3g} after 2-digit rounding (one unit of the '
                  f'last digit allowed)')
            print('\nevery layout, same answers.')
            return worst
        finally:
            cfg.DIR_MODELS = saved


if __name__ == '__main__':
    main()
