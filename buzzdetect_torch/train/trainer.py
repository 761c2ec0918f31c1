"""Training: classifier-head fine-tuning and full-model fine-tuning, on one
torch device or over a ('data', 'model') device mesh.

Counterpart of ``buzzdetect_tpu/train/trainer.py``. The reference ships no
training code; its model card records the recipe (dense head, Adam,
BinaryCrossentropy(from_logits), class weights from
`models/model_general_v3/weights.csv`). Here:

* plain functions on tensors: the losses (``head_loss``, ``full_loss``)
  and steps that run one ``backward`` and one ``torch.optim.Adam`` step
  (optax's ``adam`` in the JAX package; the two differ in rounding only);
* the same numpy draws in the same order as the JAX package, so both see
  the same batches from the same seed;
* BatchNorm running statistics are state, outside the optimizer: the full
  step overwrites them with ``yamnet.embed_train``'s, as the JAX step does
  after giving them zero gradients;
* the full step's convolutions and their gradients are ``F.conv2d`` with
  autograd (the JAX package computes them outside any Pallas kernel),
  TF32 off, and on the card with deterministic cuDNN algorithms, scoped to
  the step (``training_flags``), so a resumed run lands on the same bits.

With ``mesh=`` (``parallel.make_mesh(shape=(D, M), axes=('data',
'model'))``), as the JAX steps shard it: the batch splits over ``'data'``
(the full step by whole clips, after the frontend), the embeddings' 1024
features and the head kernel's rows over ``'model'``; each data shard's
partial logits are summed over ``'model'`` in axis order, and the loss is
the mean over the whole batch. The conv stack runs on each data shard
with BatchNorm over the whole batch (``yamnet.embed_train``). The master
parameters and the optimizer live on the mesh's first device; each step
copies every parameter to the devices that use it (``_Replicate``), and
the copies' gradients come back summed in mesh order, a fixed order
whichever card finishes first, so a resumed run on a mesh of several cards
lands on the same bits. A mesh without a ``'data'`` or ``'model'`` axis
raises ValueError, as the JAX steps do. Without a mesh the steps run the
same code on a 1 x 1 mesh of the parameters' device.
"""

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

from buzzdetect_torch.models import yamnet as yamnet_lib
from buzzdetect_torch.models.classifier import resolve_device
from buzzdetect_torch.models.heads import init_head
from buzzdetect_torch.models.weights import (flatten, is_state,
                                             train_state_from_numpy)
from buzzdetect_torch.ops.frontend import (FrontendConfig, log_mel_patches,
                                           num_patches)
from buzzdetect_torch.ops.common import exact_f32
from buzzdetect_torch.parallel.mesh import Mesh, mesh_device, split
from buzzdetect_torch.train.augment import (default_augment, draw_spec_mask,
                                            spec_mask)


def _bce_per_class(logits, labels, class_weights=None):
    per_class = -(labels * F.logsigmoid(logits)
                  + (1.0 - labels) * F.logsigmoid(-logits))
    if class_weights is not None:
        per_class = per_class * class_weights
    return per_class


def bce_with_logits_loss(logits, labels, class_weights=None):
    """Mean binary cross-entropy over classes (multi-label, from logits)."""
    return _bce_per_class(logits, labels, class_weights).mean()


class _Replicate(torch.autograd.Function):
    """``x`` copied to each of ``devices``; the backward sums the copies'
    gradients on ``x``'s device in the order of ``devices``."""

    @staticmethod
    def forward(ctx, devices, x):
        ctx.home = x.device
        return tuple(x.to(d, copy=True) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        total = grads[0].to(ctx.home)
        for g in grads[1:]:
            total = total + g.to(ctx.home)
        return None, total


def _replicate(tree: dict, devices) -> list:
    """One copy of the flat dict ``tree`` per device of ``devices``: a
    leaf that requires grad through ``_Replicate``, a state leaf as a
    plain copy."""
    copies = [{} for _ in devices]
    for k, t in tree.items():
        per = (_Replicate.apply(devices, t) if t.requires_grad
               else [t.to(d) for d in devices])
        for c, v in zip(copies, per):
            c[k] = v
    return copies


def _step_mesh(mesh, device) -> Mesh:
    """The steps' ('data', 'model') mesh, whose first device must hold the
    master parameters (``device``); without one, a 1 x 1 mesh of
    ``device``."""
    if mesh is None:
        return Mesh([[device]], ('data', 'model'))
    for axis in ('data', 'model'):
        mesh.axis_size(axis)
    if mesh.first() != device:
        raise ValueError(f'the parameters live on {device}, not on the '
                         f"mesh's first device {mesh.first()}")
    return mesh


def _sharded_head_loss(head, emb_shards, label_shards, mesh, n_rows,
                       class_weights=None):
    """The head's BCE over a batch whose rows are split over ``'data'``
    (``emb_shards[i]`` and ``label_shards[i]`` on the data devices): each
    shard's features and the head kernel's rows split over ``'model'``,
    the partial logits summed in axis order on the data device, and the
    loss summed over the shards in order and divided by the batch's
    ``n_rows`` x classes, on the mesh's first device."""
    home = mesh.first()
    data = mesh.axis_devices('data')
    heads = _replicate(head, data)
    total = None
    for i, (emb, labels) in enumerate(zip(emb_shards, label_shards)):
        if not len(emb):
            continue
        row = mesh.take('data', i)
        kernels = split(heads[i]['head/kernel'], row, 'model', 0)
        logits = None
        for e, k in zip(split(emb, row, 'model', 1), kernels):
            part = (e @ k).to(data[i])
            logits = part if logits is None else logits + part
        cw = None if class_weights is None else class_weights.to(data[i])
        part = _bce_per_class(logits + heads[i]['head/bias'], labels,
                              cw).sum().to(home)
        total = part if total is None else total + part
    return total / (n_rows * head['head/kernel'].shape[1])


def _weights(class_weights, device):
    if class_weights is None:
        return None
    return torch.as_tensor(np.asarray(class_weights, np.float32),
                           device=device)


@contextlib.contextmanager
def training_flags():
    """TF32 off (``exact_f32``) and, for the span of a step, deterministic
    cuDNN algorithms without autotuning; the previous cuDNN settings (the
    serving path's) come back on exit."""
    exact_f32()
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        yield


# --- head-only training -------------------------------------------------------

def head_loss(params, embeddings, labels, class_weights=None, mesh=None):
    """BCE of the head's logits on (B, 1024) embeddings: the rows split
    over ``mesh``'s ``'data'`` axis and the features over ``'model'``
    (``_sharded_head_loss``; a 1 x 1 mesh of the head's device without
    one)."""
    mesh = _step_mesh(mesh, params['head/kernel'].device)
    return _sharded_head_loss(params, split(embeddings, mesh, 'data', 0),
                              split(labels, mesh, 'data', 0), mesh,
                              len(embeddings), class_weights)


def make_head_train_step(optimizer, params, class_weights=None, mesh=None):
    """Train step over precomputed embeddings: ``step(embeddings, labels)``
    computes the BCE loss, its gradients and one optimizer step on
    ``params`` (the head tensors ``optimizer`` holds, on ``mesh``'s first
    device if given), and returns the loss as a 0-d tensor."""
    device = next(iter(params.values())).device
    _step_mesh(mesh, device)
    cw = _weights(class_weights, device)

    def step(embeddings, labels):
        with training_flags():
            optimizer.zero_grad(set_to_none=True)
            loss = head_loss(params, embeddings, labels, cw, mesh)
            loss.backward()
            optimizer.step()
        return loss.detach()

    return step


def epoch_batches(rng, n, batch_size):
    """One epoch's batch indices from ``rng``, as the JAX package draws
    them: a permutation, cut in order; the remainder batch is padded by
    WRAPPING to the head of a fresh permutation, so no sample is dropped
    and every batch has one shape."""
    order = rng.permutation(n)
    for i in range(0, n, batch_size):
        idx = order[i:i + batch_size]
        if len(idx) < batch_size:
            idx = np.concatenate(
                [idx, rng.permutation(n)[:batch_size - len(idx)]])
        yield idx


def train_head(embeddings, labels, n_classes=None, *, epochs=10,
               batch_size=1024, learning_rate=1e-3, class_weights=None,
               seed=0, mesh=None, log_every=0, device='cuda'):
    """Fit a dense head on (N, 1024) embeddings with multi-hot (N, C) labels
    on ``device``, or over ``mesh`` (of ``device``'s type). Returns
    (head_params as numpy, losses)."""
    device = resolve_device(device if mesh is None
                            else mesh_device(mesh, device))
    embeddings = np.asarray(embeddings, np.float32)
    labels = np.asarray(labels, np.float32)
    if len(embeddings) == 0:
        # training on nothing yields all-NaN params with no error (empty
        # mean -> NaN loss/grads); fail like train_full_model does
        raise ValueError('no embeddings to train on — check the labels/'
                         'corpus produced at least one frame')
    n_classes = n_classes or labels.shape[1]
    params, optimizer = train_state_from_numpy(
        init_head(embeddings.shape[1], n_classes, seed=seed),
        learning_rate=learning_rate, device=device)
    step = make_head_train_step(optimizer, params, class_weights, mesh)
    emb_dev = torch.from_numpy(embeddings).to(device)
    lab_dev = torch.from_numpy(labels).to(device)

    rng = np.random.default_rng(seed)
    losses = []
    n = len(embeddings)
    batch_size = min(batch_size, n)
    steps_per_epoch = -(-n // batch_size)
    for epoch in range(epochs):
        for idx in epoch_batches(rng, n, batch_size):
            sel = torch.from_numpy(idx).to(device)
            losses.append(float(step(emb_dev[sel], lab_dev[sel])))
        if log_every and (epoch + 1) % log_every == 0:
            mean_loss = float(np.mean(losses[-steps_per_epoch:]))
            print(f'epoch {epoch + 1}/{epochs}: loss {mean_loss:.4f}')
    return to_numpy(params), losses


def to_numpy(tree):
    """Tensors (nested dicts) -> numpy arrays in the same nesting."""
    return {k: (to_numpy(v) if isinstance(v, dict)
                else v.detach().cpu().numpy()) for k, v in tree.items()}


# --- full-model fine-tuning ----------------------------------------------------

def full_loss(params, waveforms, labels, cfg: FrontendConfig,
              class_weights=None, masks=None, mesh=None):
    """Raw 16 kHz waveform batch -> frontend -> MobileNet (live BatchNorm)
    -> per-clip mean of the patch embeddings -> head -> BCE.

    ``params`` = ``{'yamnet_raw': ..., 'head': ...}`` tensors; ``masks``
    (``augment.draw_spec_mask``) masks the patches. No gradient flows into
    the frontend, which runs on the parameters' device. The patches then
    split over ``mesh``'s ``'data'`` axis by whole clips (a 1 x 1 mesh of
    the parameters' device without one). Returns (loss, new BatchNorm
    statistics)."""
    mesh = _step_mesh(mesh, params['head']['head/kernel'].device)
    with torch.no_grad():
        patches = log_mel_patches(waveforms, cfg)      # (B, n_patch, 96, 64)
        if masks is not None:
            patches = spec_mask(patches, masks)
    npatch = patches.shape[1]
    shards = [p.reshape(-1, *patches.shape[2:])
              for p in split(patches, mesh, 'data', 0)]
    embs, new_stats = yamnet_lib.embed_train(
        _replicate(params['yamnet_raw'], mesh.axis_devices('data')), shards)
    # one clip-level embedding per waveform (mean over its patches)
    embs = [e.reshape(-1, npatch, e.shape[-1]).mean(dim=1) for e in embs]
    loss = _sharded_head_loss(params['head'], embs,
                              split(labels, mesh, 'data', 0), mesh,
                              len(waveforms), class_weights)
    return loss, new_stats


def make_full_train_step(optimizer, params, class_weights=None,
                         framehop_prop: float = 1.0, augment: bool = False,
                         mesh=None):
    """End-to-end train step: ``step(waveforms, labels[, rng])`` computes
    ``full_loss``, backpropagates into every conv kernel, BN beta and the
    head, takes one optimizer step, then adopts the batch's BatchNorm
    statistics. Returns the loss as a 0-d tensor.

    With ``augment=True`` the step takes an ``np.random.Generator`` and
    draws the augmentation recipe from it (gain/shift + mixup on the
    waveforms, SpecAugment masks on the patches; see train/augment.py).
    With ``mesh`` the parameters live on its first device."""
    cfg = FrontendConfig().with_framehop(framehop_prop)
    device = params['head']['head/kernel'].device
    _step_mesh(mesh, device)
    cw = _weights(class_weights, device)
    stats = {k: v for k, v in params['yamnet_raw'].items() if is_state(k)}

    def step(waveforms, labels, rng=None):
        masks = None
        if augment:
            waveforms, labels = default_augment(rng, waveforms, labels)
            n = waveforms.shape[0] * num_patches(waveforms.shape[1], cfg)
            masks = draw_spec_mask(rng, n)
        with training_flags():
            optimizer.zero_grad(set_to_none=True)
            loss, new_stats = full_loss(params, waveforms, labels, cfg, cw,
                                        masks, mesh)
            loss.backward()
            optimizer.step()
            # BN running stats are data, not parameters: adopt, don't descend
            for k, v in new_stats.items():
                stats[k].copy_(v)
        return loss.detach()

    return step


def init_full_train(n_classes: int, seed: int = 0,
                    learning_rate: float = 1e-4, device='cuda'):
    """Fresh params + optimizer for full-model fine-tuning: the JAX
    package's seeded ``init_raw_params`` and ``init_head`` on ``device``.
    Returns (params, optimizer)."""
    return train_state_from_numpy(
        {'yamnet_raw': yamnet_lib.init_raw_params(seed=seed),
         'head': init_head(yamnet_lib.N_EMBEDDINGS, n_classes, seed=seed)},
        learning_rate=learning_rate, device=resolve_device(device))


def trainable_leaves(params):
    """``[(path, tensor), ...]`` of the leaves the optimizer moves."""
    return [(p, t) for p, t in flatten(params) if t.requires_grad]
