"""Clip extraction for full-model training: annotated spans -> fixed-length
labeled waveform clips.

Full-model fine-tuning (frontend + MobileNet + head) trains on fixed-shape
waveform batches. This module tiles each annotated event into clips of the
one-patch length, and samples negative clips from un-annotated stretches, so
an event CSV plus the audio corpus is everything a from-scratch training run
needs.

Copy of ``buzzdetect_tpu/train/clips.py`` with the import prefix changed,
``audio.driver_map()`` called, and ``train_full_model`` on one torch
device (``trainer.make_full_train_step``; the state restored in place by
``checkpoint.load_train_checkpoint``). Its per-step augmentation draws
come from ``np.random.default_rng((seed, global step))`` where the JAX
package folds the global step into ``PRNGKey(seed)``: reproducible, and
a resumed run replays the same draws.
"""

import os

import numpy as np

from buzzdetect_torch.audio import build_track, get_duration
from buzzdetect_torch.ops.frontend import FrontendConfig, min_waveform_samples
from buzzdetect_torch.train.data import translate_labels


def clip_spans(events, duration: float, clip_seconds: float,
               negatives_per_positive: float = 1.0, seed: int = 0,
               overlap_prop: float = 0.2, n_negatives: int = None):
    """Plan clip extraction for one file.

    Returns a list of (start_seconds, labels) where labels is the list of
    event labels overlapping the clip (empty for negatives). Positive clips
    tile each event span; negatives sample uniformly from gaps.

    ``n_negatives``: explicit negative-clip count, overriding the
    per-file ``negatives_per_positive`` sizing — build_clip_dataset uses
    this to balance negatives corpus-wide (a file with no events sizes to
    ZERO under the per-file rule, silently dropping dedicated background
    recordings from training).
    """
    rng = np.random.default_rng(seed)
    clipped = []   # (start, end, label) clamped to the file
    covered = []
    starts = set()
    for ev_start, ev_end, label in events:
        ev_start = max(0.0, ev_start)
        ev_end = min(duration, ev_end)
        if ev_end - ev_start <= 0:
            continue
        clipped.append((ev_start, ev_end, label))
        covered.append((ev_start, ev_end))
        t = ev_start
        while t < ev_end:
            starts.add(min(t, max(0.0, duration - clip_seconds)))
            t += clip_seconds

    # label each clip with EVERY event it overlaps — time-overlapping events
    # must not produce contradictory rows (clip marked 'bee' with car=0 while
    # a car event covers the same second). An overlap only counts when it
    # covers >= overlap_prop of the clip (the same 0.2 rule as
    # annotations.frames_to_labels): the final tile of an event otherwise
    # gets labeled positive on an arbitrarily small sliver, training on
    # clips that are almost entirely unannotated audio.
    # (an event SHORTER than the threshold still counts when it lies
    # inside the clip — brief transient buzzes must not vanish from the
    # training set)
    min_overlap = overlap_prop * clip_seconds
    spans = []
    for start in sorted(starts):
        end = start + clip_seconds
        labels = sorted({lb for s, e, lb in clipped
                         if (min(e, end) - max(s, start)
                             >= min(min_overlap, e - s))})
        if not labels:
            continue  # sliver-only tile: no event meaningfully present
        spans.append((start, labels))

    n_neg = (int(round(len(spans) * negatives_per_positive))
             if n_negatives is None else int(n_negatives))
    max_start = max(0.0, duration - clip_seconds)
    tries = 0
    negatives = []
    while len(negatives) < n_neg and tries < n_neg * 20:
        tries += 1
        start = float(rng.uniform(0, max_start)) if max_start > 0 else 0.0
        if any(start < e and start + clip_seconds > s for s, e in covered):
            continue
        negatives.append((start, []))
    spans.extend(negatives)
    return spans


def extract_clips(path_audio: str, spans, clip_seconds: float,
                  samplerate: int = 16000, track=None):
    """Decode the planned clips -> (n_clips, clip_samples) float32.

    ``track``: reuse an already-open driver for the file (the caller keeps
    ownership/closing); otherwise one is opened and closed here.
    """
    n_samples = int(clip_seconds * samplerate)
    own_track = track is None
    if own_track:
        track = build_track(path_audio, target_rate=samplerate)
    try:
        out = np.zeros((len(spans), n_samples), np.float32)
        # decode in start order (output rows keep the spans order): backward
        # seeks on reopen-strategy codecs re-decode from sample zero, so a
        # shuffled span list would cost O(n_clips * file_duration)
        for i in sorted(range(len(spans)), key=lambda j: spans[j][0]):
            track.seek(int(spans[i][0] * samplerate))
            got = track.read(n_samples)
            out[i, :len(got)] = got
        return out
    finally:
        if own_track:
            track.close()


def build_clip_dataset(dir_audio: str, events_by_ident: dict, classes,
                       translation: dict = None,
                       negatives_per_positive: float = 1.0,
                       clip_seconds: float = None, seed: int = 0,
                       log=print):
    """Whole corpus -> (clips (N, L) float32, labels (N, C) multi-hot).

    ``clip_seconds`` defaults to the one-patch minimum (0.975 s), the
    smallest shape the full train step accepts.

    Negatives are balanced CORPUS-WIDE: the target count is
    ``negatives_per_positive`` x the total positive clips across all
    files, distributed over every file proportional to its un-annotated
    duration. Files with no events at all — the standard way to provide
    background examples — therefore contribute negative clips (a per-file
    rule would size them to zero and silently drop them from training).
    """
    import zlib

    from buzzdetect_torch.audio import driver_map
    from buzzdetect_torch.utils import build_ident, search_dir

    cfg = FrontendConfig()
    if clip_seconds is None:
        clip_seconds = min_waveform_samples(cfg) / cfg.sample_rate

    # phase 1 — plan positives and measure un-annotated time per file.
    # (Each file is opened twice across the two phases: once here for the
    # duration probe — allocation needs corpus totals before any
    # extraction — and once in extract_clips. The probe is a container
    # header parse; decode dominates the build, so the extra open is
    # accepted for the corpus-wide balance.)
    plan = []  # (path, ident, events, duration, n_pos, uncovered_s, cap)
    for path in search_dir(dir_audio, list(driver_map())):
        ident = build_ident(path, dir_audio)
        events = events_by_ident.get(ident, [])
        track = build_track(path, target_rate=cfg.sample_rate)
        try:
            duration = get_duration(track)
        finally:
            track.close()
        n_pos = len(clip_spans(events, duration, clip_seconds,
                               seed=seed, n_negatives=0))
        covered = 0.0
        last_end = 0.0
        spans_clamped = [(max(0.0, s), min(duration, e))
                         for s, e, _lb in events]
        for s, e in sorted((s, e) for s, e in spans_clamped if e > s):
            if e > last_end:
                covered += e - max(s, last_end)
                last_end = e
        # a gap shorter than one clip can never host a negative; counting
        # it would siphon allocation from files that can actually use it —
        # approximate by zeroing files whose total slack is sub-clip.
        # Exception: an entirely un-annotated file SHORTER than one clip
        # still hosts exactly one zero-padded negative (extract_clips pads
        # the tail), so a corpus of short background snippets isn't dropped;
        # cap it at 1 because every sample in a sub-clip file starts at 0
        # and further clips would be duplicates.
        uncovered = max(0.0, duration - covered)
        cap = None  # unbounded
        if uncovered < clip_seconds:
            if not events and duration > 0:
                uncovered, cap = duration, 1
            else:
                uncovered = 0.0
        plan.append((path, ident, events, duration, n_pos, uncovered, cap))

    # phase 2 — distribute the corpus negative budget by un-annotated time
    # (largest-remainder rounding so the total is exact when any file can
    # host a negative; files with zero weight never receive allocation)
    total_pos = sum(n_pos for *_rest, n_pos, _unc, _cap in plan)
    budget = int(round(total_pos * negatives_per_positive))
    total_unc = sum(unc for *_rest, unc, _cap in plan)
    quotas = [(budget * unc / total_unc if total_unc > 0 else 0.0)
              for *_rest, unc, _cap in plan]
    alloc = [int(q) for q in quotas]
    if total_unc > 0:
        remainder = [i for i in sorted(range(len(plan)),
                                       key=lambda j: quotas[j] - alloc[j],
                                       reverse=True)
                     if quotas[i] > 0][:budget - sum(alloc)]
        for i in remainder:
            alloc[i] += 1
    for i, (*_rest, cap) in enumerate(plan):
        if cap is not None:
            alloc[i] = min(alloc[i], cap)
    if sum(alloc) < budget:
        log(f'negative budget under-delivered: {sum(alloc)}/{budget} '
            f'(the corpus has too little un-annotated time to host the '
            f'rest)')

    all_clips, all_labels = [], []
    for (path, ident, events, duration, _n_pos, _unc, _cap), n_neg in zip(
            plan, alloc):
        # per-file seed: same-duration files must not sample negatives at
        # identical relative offsets
        file_seed = (seed * 1000003 + zlib.crc32(ident.encode())) % 2**32
        spans = clip_spans(events, duration, clip_seconds,
                           seed=file_seed, n_negatives=n_neg)
        if not spans:
            continue
        clips = extract_clips(path, spans, clip_seconds, cfg.sample_rate)
        labels = translate_labels([s for _start, s in spans],
                                  translation or {}, classes)
        all_clips.append(clips)
        all_labels.append(labels)
        log(f'clips from {ident}: {len(spans)} '
            f'({int(labels.sum())} positive labels)')

    if not all_clips:
        return (np.zeros((0, int(clip_seconds * cfg.sample_rate)), np.float32),
                np.zeros((0, len(classes)), np.float32))
    return np.concatenate(all_clips), np.concatenate(all_labels)


def train_full_model(clips, labels, *, epochs=10, batch_size=32,
                     learning_rate=1e-4, class_weights=None, mesh=None,
                     seed=0, framehop_prop=1.0, log=print,
                     checkpoint_dir=None, checkpoint_every=1,
                     augment=False, device='cuda'):
    """Fine-tune the whole embedder + head on labeled clips on ``device``.

    ``augment=True`` turns on the augmentation recipe (train/augment.py) —
    per-step draws come from a generator seeded with (seed, global step),
    so augmented runs stay reproducible and checkpoint/resume exact.

    With ``checkpoint_dir``, the full training state (params, optimizer,
    epoch, loss history, shuffle rng) is persisted atomically every
    ``checkpoint_every`` epochs and a rerun resumes from it — an
    interrupted-and-resumed run lands on bit-identical parameters (the
    analysis pipeline's kill-anytime contract, extended to training).

    Returns (raw_yamnet_params, head_params, losses) as numpy dicts, ready
    for ``convert.save_bundle`` (``yamnet_raw/*`` + ``head/*``).
    """
    import torch

    from buzzdetect_torch.train.trainer import (epoch_batches, init_full_train,
                                                make_full_train_step,
                                                to_numpy)
    from buzzdetect_torch.train.checkpoint import (load_train_checkpoint,
                                                   save_train_checkpoint)

    n_classes = labels.shape[1]

    def fresh():
        return init_full_train(n_classes, seed=seed,
                               learning_rate=learning_rate, device=device)

    params, optimizer = fresh()
    rng = np.random.default_rng(seed)
    n = len(clips)
    if n == 0:
        raise ValueError('no clips to train on (build_clip_dataset returned '
                         'an empty dataset — do the annotations reference '
                         'files in dir_audio?)')
    batch_size = min(batch_size, n)
    losses = []
    start_epoch = 0
    ckpt_path = None
    fingerprint = None
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
        ckpt_path = os.path.join(checkpoint_dir, 'finetune_ckpt.npz')
        fingerprint = {'seed': int(seed),
                       'learning_rate': float(learning_rate),
                       'batch_size': int(batch_size),
                       'framehop_prop': float(framehop_prop),
                       'n_clips': int(n),
                       'n_classes': int(n_classes)}
        if augment:
            # only keyed when ON, as in the JAX package: an unaugmented
            # run's fingerprint is the same there and here
            fingerprint['augment'] = True
        restored = load_train_checkpoint(ckpt_path, params, optimizer,
                                         log=log, fingerprint=fingerprint)
        if restored is not None and restored[0] > epochs:
            # a leftover checkpoint from a LONGER completed run: adopting it
            # would silently return over-trained parameters as if they were
            # the requested run
            log(f'ignoring checkpoint {ckpt_path}: it is at epoch '
                f'{restored[0]}, ahead of the requested {epochs} — '
                f'training fresh')
            restored = None
            params, optimizer = fresh()
        if restored is not None:
            start_epoch, losses, rng = restored
            log(f'resuming fine-tune from {ckpt_path} '
                f'(epoch {start_epoch}/{epochs})')
    step = make_full_train_step(optimizer, params,
                                class_weights=class_weights,
                                framehop_prop=framehop_prop,
                                augment=augment, mesh=mesh)
    dev = params['head']['head/kernel'].device
    clips_dev = torch.from_numpy(np.asarray(clips, np.float32)).to(dev)
    labels_dev = torch.from_numpy(np.asarray(labels, np.float32)).to(dev)
    for epoch in range(start_epoch, epochs):
        # remainder batch wraps to a fresh shuffle's head (see
        # trainer.train_head): no samples silently dropped per epoch
        for idx in epoch_batches(rng, n, batch_size):
            sel = torch.from_numpy(idx).to(dev)
            args = (clips_dev[sel], labels_dev[sel])
            if augment:
                # draws = f(seed, global step): reproducible, and the
                # global step (len(losses)) rides the checkpoint, so an
                # interrupted augmented run resumes on the exact draws
                args += (np.random.default_rng((seed, len(losses))),)
            losses.append(float(step(*args)))
        log(f'epoch {epoch + 1}/{epochs}: loss {losses[-1]:.4f}')
        if ckpt_path and (epoch + 1) % max(1, checkpoint_every) == 0:
            save_train_checkpoint(ckpt_path, params, optimizer,
                                  epoch + 1, losses, rng,
                                  fingerprint=fingerprint)

    raw = to_numpy(params['yamnet_raw'])
    head = to_numpy(params['head'])
    return raw, head, losses
