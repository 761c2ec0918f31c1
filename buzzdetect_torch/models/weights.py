"""Weights carried across from the JAX package's numpy parameters.

``params_from_numpy`` turns the arrays a bundle (``model.npz``) or the JAX
package's ``yamnet`` functions hold into the port's tensors, in the layouts
the port's kernels take.
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
