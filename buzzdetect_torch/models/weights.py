"""Weights carried across from the JAX package's numpy parameters.

``params_from_numpy`` turns the arrays a bundle (``model.npz``) or the JAX
package's ``yamnet`` functions hold into the port's tensors, in the layouts
the port's kernels take. ``train_state_from_numpy`` carries a training
state across: raw parameters (and, to continue a run, Adam's moments) as
the JAX package's training step holds them, into tensors and a
``torch.optim.Adam`` over them.
"""

import numpy as np
import torch

from buzzdetect_torch.models import yamnet


def _yamnet_tensors(folded: dict, device) -> dict:
    """Folded HWIO numpy params -> tensors in kernel layout:

    * ``layer1/conv/kernel``: OIHW (32, 1, 3, 3) for ``F.conv2d``;
    * ``layerN/depthwise_conv/kernel``: (9, C) taps, tap t = (dy+1)*3 +
      (dx+1) = kernel[dy+1, dx+1, 0, :];
    * ``layerN/pointwise_conv/kernel``: (C, F) row-major;
    * every ``.../bias``: 1-D f32.
    """
    out = {}
    for key, kind, _stride, shape in yamnet._conv_shapes():
        k = np.asarray(folded[f'{key}/kernel'], np.float32)
        if kind == 'depthwise':
            k = k.reshape(9, shape[3])
        elif shape[0] == 1:  # pointwise (1, 1, C, F)
            k = k.reshape(shape[2], shape[3])
        else:  # layer 1 full conv: HWIO -> OIHW
            k = k.transpose(3, 2, 0, 1)
        out[f'{key}/kernel'] = torch.from_numpy(
            np.ascontiguousarray(k)).to(device)
        out[f'{key}/bias'] = torch.from_numpy(
            np.asarray(folded[f'{key}/bias'], np.float32)).to(device)
    return out


def params_from_numpy(arrays: dict, device='cpu') -> dict:
    """Numpy parameters -> ``{'yamnet': {...}, 'head': {...}}`` tensors on
    ``device`` (``'head'`` only when the arrays carry one).

    Accepts the embedder weights raw (``yamnet_raw/*``, BatchNorm statistics
    included: folded here with eps 1e-4, as ``yamnet.fold_batchnorm`` does),
    already folded (``yamnet/*``), or unprefixed as the JAX package's
    ``init_raw_params`` / ``fold_batchnorm`` return them. Other keys (a
    bundle's metrics tables) are ignored.
    """
    emb, head = {}, {}
    for k, v in arrays.items():
        if k.startswith('head/'):
            head[k] = torch.from_numpy(
                np.ascontiguousarray(v, np.float32)).to(device)
        elif k.startswith(('yamnet/', 'yamnet_raw/', 'layer')):
            emb[k.split('/', 1)[1] if not k.startswith('layer') else k] = v
    if not emb:
        raise ValueError('bundle missing yamnet/ or yamnet_raw/ parameters')
    if any(k.endswith('/bn_mean') for k in emb):
        emb = yamnet.fold_batchnorm(emb)
    params = {'yamnet': _yamnet_tensors(emb, device)}
    if head:
        params['head'] = head
    return params


# BatchNorm running statistics: state the training step overwrites, never
# a parameter the optimizer moves
STATE_SUFFIXES = ('bn_mean', 'bn_var')


def flatten(tree: dict, prefix: str = ''):
    """``[(path, leaf), ...]`` of a nested dict in sorted-key order, the
    order ``jax.tree_util.tree_leaves`` gives a dict of dicts."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = f'{prefix}{k}'
        if isinstance(v, dict):
            out.extend(flatten(v, path + '.'))
        else:
            out.append((path, v))
    return out


def _map_tree(tree: dict, fn, prefix: str = ''):
    return {k: (_map_tree(v, fn, f'{prefix}{k}.') if isinstance(v, dict)
                else fn(f'{prefix}{k}', v)) for k, v in tree.items()}


def is_state(path: str) -> bool:
    """True for a BatchNorm running statistic (not trained by Adam)."""
    return path.endswith(STATE_SUFFIXES)


def train_state_from_numpy(params: dict, mu: dict = None, nu: dict = None,
                           count: int = 0, learning_rate: float = 1e-4,
                           device='cpu'):
    """A training state of the JAX package -> ``(tensors, optimizer)``.

    ``params`` is a (nested) dict of numpy arrays in the JAX package's
    layout, e.g. ``{'yamnet_raw': {...}, 'head': {...}}`` or the flat head
    dict; every leaf becomes an f32 tensor on ``device`` in the same
    nesting. Leaves that are BatchNorm statistics (``is_state``) are
    state; every other leaf requires grad and is a parameter of the
    returned ``torch.optim.Adam(lr=learning_rate)``, in ``flatten`` order.
    ``mu`` and ``nu`` (optax's ``ScaleByAdamState`` moments, same nesting;
    their entries for the statistics are ignored) and ``count`` (its step
    count) set Adam's ``exp_avg``, ``exp_avg_sq`` and ``step``, so the
    next step continues the JAX run.
    """
    def leaf(path, v):
        t = torch.from_numpy(np.array(v, np.float32)).to(device)
        return t.requires_grad_(not is_state(path))

    tensors = _map_tree(params, leaf)
    trainable = [t for _p, t in flatten(tensors) if t.requires_grad]
    optimizer = torch.optim.Adam(trainable, lr=learning_rate)
    if mu is not None:
        moments = dict(flatten(mu)), dict(flatten(nu))
        for path, t in flatten(tensors):
            if t.requires_grad:
                optimizer.state[t] = {
                    'step': torch.tensor(float(count), dtype=torch.float32),
                    'exp_avg': torch.from_numpy(np.array(
                        moments[0][path], np.float32)).to(device),
                    'exp_avg_sq': torch.from_numpy(np.array(
                        moments[1][path], np.float32)).to(device)}
    return tensors, optimizer
