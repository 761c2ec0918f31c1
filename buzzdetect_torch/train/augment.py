"""Training augmentation: the counterpart of
``buzzdetect_tpu/train/augment.py``.

Field corpora are small (hundreds of labeled clips), so full-model
fine-tunes overfit fast; these are the standard audio countermeasures:

* waveform: random gain (uniform in dB) and random circular time shift;
* mixup (Zhang et al. 2017): convex combinations of clips and their
  multi-hot labels within the batch;
* SpecAugment-style masking (Park et al. 2019): random time and mel-band
  masks on the (96, 64) patches.

``jax.random``'s streams cannot be reproduced here, so each transform is
split in two: its draws (``draw_*``: gains, shifts, mixup partners and
weights, mask widths and positions), made on the host from an explicit
``np.random.Generator`` with the JAX package's distributions, and its
application (``augment_waveforms``, ``mixup``, ``spec_mask``), which takes
those draws and computes exactly what the JAX function computes from its
own. The draws are a few numbers per clip; the application runs on the
batch's device.
"""

import numpy as np
import torch


def draw_waveform_augment(rng: np.random.Generator, b: int, *,
                          gain_db: float = 6.0, max_shift_s: float = 0.25,
                          sample_rate: int = 16000):
    """(gains (B, 1) f32, shifts (B,) int64): gains 10^(u/20) with u uniform
    in [-gain_db, gain_db), shifts uniform integers in [-max_shift,
    max_shift], max_shift = int(max_shift_s * sample_rate)."""
    u = rng.uniform(-gain_db, gain_db, (b, 1)).astype(np.float32)
    gains = np.float32(10.0) ** (u / np.float32(20.0))
    max_shift = int(max_shift_s * sample_rate)
    shifts = rng.integers(-max_shift, max_shift + 1, b)
    return gains, shifts


def augment_waveforms(waveforms: torch.Tensor, gains, shifts):
    """Each clip rolled circularly by its shift (``jnp.roll``: out[i] =
    w[i - s]), then scaled by its gain. (B, T) -> (B, T), same dtype."""
    b, t = waveforms.shape
    dev = waveforms.device
    shifts = torch.as_tensor(np.array(shifts), device=dev)
    gains = torch.as_tensor(np.array(gains, np.float32), device=dev)
    idx = (torch.arange(t, device=dev)[None, :] - shifts[:, None]) % t
    rolled = torch.gather(waveforms, 1, idx)
    return (rolled * gains.reshape(b, 1)).to(waveforms.dtype)


def draw_mixup(rng: np.random.Generator, b: int, *, alpha: float = 0.3):
    """(perm (B,) int64, lam (B,) f32): a random permutation of the batch
    for partners, and Beta(alpha, alpha) weights folded to max(l, 1 - l)
    so every clip keeps its own identity as the majority component."""
    perm = rng.permutation(b)
    lam = rng.beta(alpha, alpha, b).astype(np.float32)
    return perm, np.maximum(lam, np.float32(1.0) - lam)


def mixup(waveforms: torch.Tensor, labels: torch.Tensor, perm, lam):
    """x = l*x_i + (1-l)*x_perm(i), the same for the multi-hot labels."""
    dev = waveforms.device
    perm = torch.as_tensor(np.array(perm), device=dev)
    lw = torch.as_tensor(np.array(lam, np.float32), device=dev)[:, None]
    mixed_x = lw * waveforms + (1.0 - lw) * waveforms[perm]
    mixed_y = lw * labels + (1.0 - lw) * labels[perm]
    return mixed_x.to(waveforms.dtype), mixed_y


def draw_spec_mask(rng: np.random.Generator, n: int, t_dim: int = 96,
                   f_dim: int = 64, *, n_time_masks: int = 1,
                   max_time: int = 16, n_freq_masks: int = 1,
                   max_freq: int = 8):
    """Per patch and mask, a width uniform in [0, max] and a start uniform in
    [0, max(axis_len - width, 1)): ``{'time': (at, width), 'freq': (at,
    width)}``, each array (n, n_masks) int64."""
    out = {}
    for axis, axis_len, n_masks, max_width in (
            ('time', t_dim, n_time_masks, max_time),
            ('freq', f_dim, n_freq_masks, max_freq)):
        width = rng.integers(0, max_width + 1, (n, n_masks))
        at = rng.integers(0, np.maximum(axis_len - width, 1))
        out[axis] = (at, width)
    return out


def spec_mask(patches: torch.Tensor, masks: dict):
    """Zero each patch's masked rows (time) and columns (mel bands):
    (..., 96, 64) with ``masks`` from ``draw_spec_mask`` for the
    ``prod(...)`` patches in row-major order."""
    t_dim, f_dim = patches.shape[-2], patches.shape[-1]
    flat = patches.reshape(-1, t_dim, f_dim)
    dev = patches.device
    keep = {}
    for axis, axis_len in (('time', t_dim), ('freq', f_dim)):
        at, width = (torch.as_tensor(np.array(a), device=dev)[..., None]
                     for a in masks[axis])
        idx = torch.arange(axis_len, device=dev)
        # (n, n_masks, axis_len) -> kept where no mask covers the index
        keep[axis] = ((idx < at) | (idx >= at + width)).all(dim=1)
    out = (flat * keep['time'][:, :, None].to(flat.dtype)
           * keep['freq'][:, None, :].to(flat.dtype))
    return out.reshape(patches.shape)


def default_augment(rng: np.random.Generator, waveforms: torch.Tensor,
                    labels: torch.Tensor):
    """The standard recipe: gain + shift, then mixup. Returns (waveforms,
    labels). Patch masking is applied separately by the train step (it
    needs the post-frontend representation)."""
    b = waveforms.shape[0]
    waveforms = augment_waveforms(waveforms,
                                  *draw_waveform_augment(rng, b))
    return mixup(waveforms, labels, *draw_mixup(rng, b))
