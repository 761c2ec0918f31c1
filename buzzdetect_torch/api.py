"""Convenience Python API for interactive use (notebooks, scripts).

The pipeline (`analyze`) is the production path; these helpers cover the
"just score this file" cases without directories, CSVs, or worker threads.

Copy of ``buzzdetect_tpu/api.py`` with ``device`` threaded through
(``'cuda'`` unless the caller asks for ``'cpu'``; it applies when a model is
loaded by name, and a pre-loaded ``model`` keeps its own).
"""

import numpy as np

from buzzdetect_torch import config as cfg
from buzzdetect_torch.audio import build_track, get_duration
from buzzdetect_torch.models.registry import load_model
from buzzdetect_torch.write.coverage import gaps_to_chunklist


def _resolve_model(model, modelname, framehop_prop, device):
    """Load a model, or check a pre-loaded one against framehop_prop.

    A pre-loaded model carries its framehop; silently ignoring a conflicting
    ``framehop_prop`` would hand back scores at the wrong stride.
    """
    if model is None:
        return load_model(modelname or cfg.DEFAULT_MODEL,
                          framehop_prop=(1.0 if framehop_prop is None
                                         else framehop_prop),
                          initialize=True, device=device)
    if framehop_prop is not None:
        # compare the configured proportion, NOT framehop_s/framelength_s:
        # framehop_s snaps to the spectrogram grid (ops/frontend.py
        # with_framehop), so the back-derived ratio differs from the
        # requested prop whenever 96*prop is not an integer
        actual = model.embedder.framehop_prop
        if abs(actual - framehop_prop) > 1e-9:
            raise ValueError(
                f'framehop_prop={framehop_prop} conflicts with the passed '
                f'model (loaded with framehop_prop={actual:g}); reload via '
                f'load_model(..., framehop_prop={framehop_prop}) or drop '
                f'the argument')
    return model


def stream_scores(path_audio: str, modelname: str = None,
                  framehop_prop: float = None, chunklength: float = 200.0,
                  model=None, device='cuda'):
    """Yield ``(start_seconds, scores)`` per analysis frame of one file.

    Streams chunk by chunk — arbitrarily long recordings never materialize
    in memory. ``scores`` is a (n_classes,) float array; class order is
    ``model.config['classes']``. ``framehop_prop`` defaults to 1.0 when
    loading by name; with a pre-loaded ``model`` it must match the model's
    configured framehop (or be omitted).
    """
    model = _resolve_model(model, modelname, framehop_prop, device)
    fl = model.embedder.framelength_s
    framehop_s = model.embedder.framehop_s
    chunklength = max(round(chunklength / fl) * fl, fl)

    track = build_track(path_audio, target_rate=model.embedder.samplerate)
    try:
        duration = get_duration(track)
        rate = track.samplerate
        for t0, t1 in gaps_to_chunklist([(0.0, duration)], chunklength):
            sample_from = int(t0 * rate)
            # the pipeline streamer's span math (int(t1*rate) - sample_from)
            # — the in-memory API must score the same samples analyze() does
            read_size = int(t1 * rate) - sample_from
            track.seek(sample_from)
            samples = track.read(read_size)
            if len(samples) == 0:
                return
            scores = model.predict(samples)
            for i, row in enumerate(scores):
                yield round(t0 + i * framehop_s,
                            model.embedder.digits_time), row
            if len(samples) < read_size:
                return  # truncated audio (bad read): stop at real content
    finally:
        track.close()


def score_file(path_audio: str, modelname: str = None,
               framehop_prop: float = None, chunklength: float = 200.0,
               model=None, device='cuda'):
    """Score a whole file -> (starts (n,), scores (n, n_classes), classes)."""
    model = _resolve_model(model, modelname, framehop_prop, device)
    starts, rows = [], []
    for t, row in stream_scores(path_audio, model=model,
                                chunklength=chunklength):
        starts.append(t)
        rows.append(row)
    return (np.asarray(starts),
            np.asarray(rows) if rows else np.zeros((0, len(model.config['classes']))),
            list(model.config['classes']))
