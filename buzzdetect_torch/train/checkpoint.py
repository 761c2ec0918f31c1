"""Atomic epoch-granular checkpointing for long fine-tunes.

Counterpart of ``buzzdetect_tpu/train/checkpoint.py``, with the same
contract and npz layout. State = params (BatchNorm statistics included),
Adam's state, epoch counter, loss history, and the numpy Generator's bit
state — so an interrupted-and-resumed run replays the exact shuffles and
lands on bit-identical parameters.

The layout is the JAX package's: ``p{i}`` the parameter leaves in sorted-key
order (``weights.flatten``), ``o{i}`` the optimizer leaves as optax's
``adam`` state flattens (the step count, then ``mu`` for every parameter
leaf, then ``nu``; zeros for the BatchNorm statistics, which the optimizer
never moves), and ``meta_json``. Restoring splices the saved leaves into
the caller's freshly built tensors and optimizer in place, refusing
(returning None, nothing touched) on any leaf-count or shape mismatch — a
checkpoint from a different model/optimizer config is ignored rather than
half-loaded. Writes are save-to-temp + fsync + os.replace, so a kill
mid-write can never tear the file a resume reads.
"""

import json
import os

import numpy as np
import torch

from buzzdetect_torch.models.weights import flatten


def _adam_leaves(params, optimizer):
    """optax ``adam``'s state leaves for ``params``: [count, mu..., nu...]
    as numpy, zeros where Adam holds no state (statistics; before the
    first step)."""
    leaves = flatten(params)
    count = 0
    mu, nu = [], []
    for _path, t in leaves:
        st = optimizer.state.get(t, {})
        if st:
            count = int(st['step'])
        zero = np.zeros(tuple(t.shape), np.float32)
        mu.append(st['exp_avg'].detach().cpu().numpy() if st else zero)
        nu.append(st['exp_avg_sq'].detach().cpu().numpy() if st else zero)
    return [np.asarray(count, np.int32)] + mu + nu


def save_train_checkpoint(path, params, optimizer, epoch, losses, rng,
                          fingerprint=None):
    """Atomically persist the full training state after ``epoch`` epochs.

    ``fingerprint`` is an arbitrary JSON-able dict of run identity (seed,
    learning rate, dataset size, ...); a resume with a different
    fingerprint ignores the checkpoint instead of silently continuing a
    different training run.
    """
    p_leaves = [t.detach().cpu().numpy() for _p, t in flatten(params)]
    o_leaves = _adam_leaves(params, optimizer)
    arrays = {f'p{i}': x for i, x in enumerate(p_leaves)}
    arrays.update({f'o{i}': x for i, x in enumerate(o_leaves)})
    meta = {'epoch': int(epoch),
            'losses': [float(x) for x in losses],
            'rng_state': rng.bit_generator.state,
            'fingerprint': fingerprint,
            'n_p': len(p_leaves), 'n_o': len(o_leaves)}
    arrays['meta_json'] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8).copy()
    tmp = f'{path}.tmp.{os.getpid()}'
    with open(tmp, 'wb') as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_train_checkpoint(path, params, optimizer, log=None,
                          fingerprint=None):
    """Restore training state saved by save_train_checkpoint.

    ``params``/``optimizer`` are a freshly initialized state of the SAME
    configuration (``trainer.init_full_train``); the saved leaves are
    copied into them in place. Returns (epoch, losses, rng) or None when
    there is no checkpoint or it does not match this configuration, in
    which case ``params`` and ``optimizer`` are left as they were.
    """
    if not os.path.exists(path):
        return None

    def reject(why):
        if log:
            log(f'ignoring checkpoint {path}: {why}')
        return None

    p_leaves = flatten(params)
    n_o = 1 + 2 * len(p_leaves)
    try:
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(bytes(z['meta_json']).decode())
            if meta['n_p'] != len(p_leaves) or meta['n_o'] != n_o:
                return reject('different model/optimizer configuration')
            if meta.get('fingerprint') != fingerprint:
                return reject('different run (seed/hyperparameters/dataset '
                              'changed) — training fresh')
            new_p = [np.asarray(z[f'p{i}']) for i in range(len(p_leaves))]
            new_o = [np.asarray(z[f'o{i}']) for i in range(n_o)]
    except Exception as e:  # unreadable/torn/foreign file: train fresh
        return reject(f'unreadable ({type(e).__name__}: {e})')

    n = len(p_leaves)
    mu, nu = new_o[1:1 + n], new_o[1 + n:]
    for (_path, t), x, m, v in zip(p_leaves, new_p, mu, nu):
        if not tuple(t.shape) == x.shape == m.shape == v.shape:
            return reject('leaf shape mismatch — different configuration')

    count = int(new_o[0])
    with torch.no_grad():
        for (_path, t), x, m, v in zip(p_leaves, new_p, mu, nu):
            t.copy_(torch.from_numpy(x))
            if t.requires_grad and count > 0:
                optimizer.state[t] = {
                    'step': torch.tensor(float(count), dtype=torch.float32),
                    'exp_avg': torch.from_numpy(m).to(t.device),
                    'exp_avg_sq': torch.from_numpy(v).to(t.device)}
    rng = np.random.default_rng()
    rng.bit_generator.state = meta['rng_state']
    return int(meta['epoch']), list(meta['losses']), rng
