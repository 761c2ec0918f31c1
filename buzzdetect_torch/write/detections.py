"""Offline detection calling: archived activations -> detections/events.

The reference's recommended workflow is to analyze once in activations
mode (archival) and call detections afterwards with the buzzr companion
package (reference `docs/source/result_files.rst:76`); this module is
that capability in-framework: threshold archived activations at ANY
precision after the fact — no re-analysis — and coalesce consecutive
detected frames into events (start/end/duration, peak and mean
activation), the unit field studies actually count. Reads both result
CSVs and `trim`'s compressed `_buzztrim.npz` archives.

Copy of ``buzzdetect_tpu/write/detections.py`` with the import prefix
changed and a float block from a plugin driver quantized by
``utils.quantize_int16`` (the same values as the native stage's
``quantize_s16``, with or without that stage).
"""

import csv
import os

import numpy as np

from buzzdetect_torch import config as cfg
from buzzdetect_torch.write.trim import SUFFIX_TRIMMED, read_results, \
    read_trimmed

EVENT_FIELDS = ('ident', 'class', 'start', 'end', 'duration', 'n_frames',
                'activation_max', 'activation_mean')


def frames_to_events(starts, activations, threshold,
                     framelength_s: float = 0.96,
                     merge_gap_s: float = None):
    """Coalesce frames whose activation exceeds ``threshold`` into events.

    Consecutive detected frames merge when the gap between their start
    times is at most ``merge_gap_s`` (default: 1.5x the median frame hop,
    which merges contiguous frames and tolerates float noise but keeps
    separated bouts apart). An event spans [first_start,
    last_start + framelength_s).

    Returns a list of dicts with start/end/duration/n_frames/
    activation_max/activation_mean.
    """
    starts = np.asarray(starts, np.float64)
    activations = np.asarray(activations, np.float64)
    order = np.argsort(starts, kind='stable')
    starts, activations = starts[order], activations[order]
    detected = activations > threshold
    if not detected.any():
        return []
    if merge_gap_s is None:
        hops = np.diff(starts)
        hops = hops[hops > 0]
        merge_gap_s = 1.5 * float(np.median(hops)) if len(hops) \
            else framelength_s
    events = []
    run = None  # [i_first, i_last]
    det_idx = np.flatnonzero(detected)
    for i in det_idx:
        if run is not None and starts[i] - starts[run[1]] <= merge_gap_s:
            run[1] = i
            continue
        if run is not None:
            events.append(run)
        run = [i, i]
    events.append(run)

    out = []
    for i0, i1 in events:
        acts = activations[i0:i1 + 1][detected[i0:i1 + 1]]
        out.append({
            'start': float(starts[i0]),
            'end': float(starts[i1] + framelength_s),
            'duration': float(starts[i1] + framelength_s - starts[i0]),
            'n_frames': int(detected[i0:i1 + 1].sum()),
            'activation_max': float(acts.max()),
            'activation_mean': float(acts.mean()),
        })
    return out


def _load_result(path):
    """(starts, {column: values}) from a result CSV or a trimmed npz."""
    if path.endswith(SUFFIX_TRIMMED):
        return read_trimmed(path)
    return read_results(path)


def call_detections_file(path, threshold, classes=('ins_buzz',),
                         framelength_s: float = 0.96,
                         merge_gap_s: float = None):
    """Call events for one archived result file.

    Returns {class: [event, ...]}; classes missing from the file are
    reported as absent via a KeyError naming the available columns.
    """
    starts, cols = _load_result(path)
    out = {}
    for cls in classes:
        col = cfg.PREFIX_COLUMN_ACTIVATION + cls
        if col not in cols:
            raise KeyError(
                f'{path} has no column {col!r}; available: '
                f'{sorted(cols)} (was the archive trimmed to other '
                f'classes?)')
        out[cls] = frames_to_events(starts, cols[col], threshold,
                                    framelength_s=framelength_s,
                                    merge_gap_s=merge_gap_s)
    return out


def add_calibration_args(ap):
    """The one shared definition of the offline-calling calibration flags
    (--threshold/--precision/--recall) for the tools built on
    :func:`call_detections_directory` — call_detections.py and
    activity_report.py must not drift apart."""
    ap.add_argument('--threshold', type=float, default=None,
                    help='explicit activation threshold')
    ap.add_argument('--precision', type=float, default=None,
                    help='requested precision; the threshold comes from '
                         'the model\'s metrics table')
    ap.add_argument('--recall', type=float, default=None,
                    help='requested recall floor ("miss at most this '
                         'fraction of true events"): the most precise '
                         'measured operating point still catching this '
                         'fraction, from the model\'s metrics table')


def check_calibration_args(ap, args):
    """Enforce the calibration contract at the PARSER (clean error, not a
    library traceback): exactly one of the three flags, recall in (0, 1]
    — the only bound knowable without the metrics table."""
    n_given = sum(x is not None
                  for x in (args.threshold, args.precision, args.recall))
    if n_given != 1:
        ap.error('pass exactly one of --threshold, --precision or --recall')
    if args.recall is not None and not 0.0 < args.recall <= 1.0:
        ap.error(f'--recall must be in (0, 1], got {args.recall}')


def _resolve_threshold(dir_results, threshold, precision, modelname,
                       recall=None):
    n_given = sum(x is not None for x in (threshold, precision, recall))
    if n_given != 1:
        raise ValueError(
            'pass exactly one of threshold=, precision= or recall=')
    if threshold is not None:
        return float(threshold)
    if modelname is None:
        from buzzdetect_torch.manifest import read_manifest
        manifest = read_manifest(dir_results)
        if not manifest or 'modelname' not in manifest:
            raise ValueError(
                'precision=/recall= needs the model whose metrics table '
                'calibrates it; pass modelname= (no manifest found in the '
                'results directory)')
        modelname = manifest['modelname']
    if recall is not None:
        from buzzdetect_torch.write.thresholds import threshold_at_recall
        return float(threshold_at_recall(modelname, recall)['threshold'])
    from buzzdetect_torch.write.thresholds import calculate_threshold
    return float(calculate_threshold(modelname, precision))


def call_detections_directory(dir_results, *, threshold=None,
                              precision=None, recall=None, modelname=None,
                              classes=('ins_buzz',),
                              framelength_s: float = 0.96,
                              merge_gap_s: float = None,
                              path_out=None, on_skip=None):
    """Call events for every archived result under ``dir_results``.

    The threshold comes either explicitly (``threshold=``), from a
    requested ``precision=`` ("detections at least this clean"), or from
    a requested ``recall=`` ("catch at least this fraction of true
    events" — the abundance-survey dual, resolved by
    :func:`buzzdetect_torch.write.thresholds.threshold_at_recall`), each
    via the model's bundled metrics table (the
    model defaults to the one recorded in the directory's manifest).
    Reads finalized CSVs and trimmed npz archives; when both exist for an
    ident the CSV wins (full precision). Returns the combined event rows
    (EVENT_FIELDS order) and optionally writes them as one CSV.

    A single archive lacking the requested class columns (trimmed to other
    classes, or a detections-mode file) must not abort a corpus-scale
    batch: such files are SKIPPED and reported through ``on_skip(path,
    reason)`` (default: ``warnings.warn``).
    """
    thr = _resolve_threshold(dir_results, threshold, precision, modelname,
                             recall=recall)
    paths = {}
    for root, _dirs, files in os.walk(dir_results):
        for fname in sorted(files):
            if fname.endswith(cfg.SUFFIX_RESULT_COMPLETE):
                ident = os.path.relpath(
                    os.path.join(root, fname), dir_results
                )[:-len(cfg.SUFFIX_RESULT_COMPLETE)]
                paths[ident] = os.path.join(root, fname)
            elif fname.endswith(SUFFIX_TRIMMED):
                ident = os.path.relpath(
                    os.path.join(root, fname), dir_results
                )[:-len(SUFFIX_TRIMMED)]
                paths.setdefault(ident, os.path.join(root, fname))

    rows = []
    for ident in sorted(paths):
        try:
            per_class = call_detections_file(
                paths[ident], thr, classes=classes,
                framelength_s=framelength_s, merge_gap_s=merge_gap_s)
        except Exception as e:
            # broad by contract: one bad archive (schema KeyError, parse
            # ValueError, but ALSO a truncated npz raising
            # zipfile.BadZipFile or a permission OSError) must not abort a
            # corpus-scale batch with zero events written for the healthy
            # files
            reason = f'{type(e).__name__}: {e}'
            if on_skip is not None:
                on_skip(paths[ident], reason)
            else:
                import warnings
                warnings.warn(f'skipping {paths[ident]}: {reason}')
            continue
        for cls, events in per_class.items():
            for e in events:
                rows.append({'ident': ident, 'class': cls, **{
                    k: e[k] for k in EVENT_FIELDS if k in e}})

    if path_out is not None:
        with open(path_out, 'w', newline='') as f:
            w = csv.DictWriter(f, fieldnames=EVENT_FIELDS)
            w.writeheader()
            w.writerows(rows)
    return rows


def write_audacity_labels(rows, dir_out):
    """Export called events as Audacity label tracks, one per ident.

    Audacity's label format is one line per label: ``start<TAB>end<TAB>
    text`` (seconds, no header); File > Import > Labels attaches the track
    to the recording. Labels are per audio file, so this writes
    ``<ident>_labels.txt`` under ``dir_out`` for each ident present in
    ``rows`` (the output of :func:`call_detections_directory`); the label
    text is ``<class> max=<activation_max>`` so the strongest events are
    findable at a glance. Returns the written paths.
    """
    by_ident = {}
    for r in rows:
        by_ident.setdefault(r['ident'], []).append(r)
    written = []
    for ident, mine in sorted(by_ident.items()):
        path = os.path.join(dir_out, ident + '_labels.txt')
        os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
        with open(path, 'w') as f:
            for r in sorted(mine, key=lambda r: (r['start'], r['class'])):
                f.write(f"{r['start']:.6f}\t{r['end']:.6f}\t"
                        f"{r['class']} max={r['activation_max']:.2f}\n")
        written.append(path)
    return written


RAVEN_FIELDS = ('Selection', 'View', 'Channel', 'Begin Time (s)',
                'End Time (s)', 'Low Freq (Hz)', 'High Freq (Hz)',
                'Annotation')


def write_raven_tables(rows, dir_out, low_hz: float = 125.0,
                       high_hz: float = 7500.0):
    """Export called events as Raven Pro selection tables, one per ident.

    Tab-separated with Raven's standard columns; one selection per event,
    numbered per table. One table per recording because Raven interprets
    ``Begin Time (s)`` as a position on the opened sound's cumulative
    timeline: a single corpus-wide table of within-file offsets would
    misplace every selection after the first file, and cumulative times
    would need exact per-file durations the event rows don't carry. Each
    ``<ident>_selections.txt`` under ``dir_out`` pairs with its recording
    (File > Open Selection Table after opening the sound). The detector is
    not frequency-localized; the frequency bounds default to the model's
    mel analysis band (125-7500 Hz for YAMNet) and mark the band the
    decision was made over, not a measured event bandwidth. ``Annotation``
    is ``<class> max=<activation_max>``. Returns the written paths.
    """
    by_ident = {}
    for r in rows:
        by_ident.setdefault(r['ident'], []).append(r)
    written = []
    for ident, mine in sorted(by_ident.items()):
        path = os.path.join(dir_out, ident + '_selections.txt')
        os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
        with open(path, 'w', newline='') as f:
            w = csv.writer(f, delimiter='\t', lineterminator='\n')
            w.writerow(RAVEN_FIELDS)
            ordered = sorted(mine, key=lambda r: (r['start'], r['class']))
            for i, r in enumerate(ordered, start=1):
                w.writerow([i, 'Spectrogram 1', 1,
                            f"{r['start']:.6f}", f"{r['end']:.6f}",
                            f'{low_hz:g}', f'{high_hz:g}',
                            f"{r['class']} max={r['activation_max']:.2f}"])
        written.append(path)
    return written


def _audio_by_ident(dir_audio):
    """Map result idents -> source audio paths, mirroring the analyzer's
    own discovery (analysis.py ident construction): a directory is walked
    recursively for supported extensions; a single file maps under its
    basename ident."""
    from buzzdetect_torch.audio import driver_map
    from buzzdetect_torch.utils import search_dir, build_ident
    if os.path.isfile(dir_audio):
        root = os.path.dirname(os.path.abspath(dir_audio))
        found = [os.path.abspath(dir_audio)]
    else:
        root = dir_audio
        found = search_dir(dir_audio, list(driver_map))
    return {build_ident(p, root): p for p in found}


def write_event_clips(rows, dir_audio, dir_out, pad_s: float = 1.0,
                      rate: int = 16000, on_skip=None):
    """Cut each called event out of its source recording as a WAV clip.

    The review step after event calling: a researcher confirming
    detections wants to HEAR them without scrubbing through hours-long
    recordings (the reference ecosystem leaves this to hand work in
    Audacity/Raven via the exported labels; this does the cut directly).
    Each event in ``rows`` (the output of
    :func:`call_detections_directory`) becomes
    ``<ident>_<class>_<start>-<end>s.wav`` under ``dir_out`` (ident
    subdirectories mirrored), spanning the event padded by ``pad_s`` of
    context on each side (clamped to the recording).

    ``rate`` is the clip samplerate: the default 16000 is the model's
    analysis rate — the clip is exactly the mono view the detector
    heard; pass 0/None for the recording's native rate (a full-bandwidth
    listening copy). Decoding rides the same native stage as analysis
    (sample-accurate seeks per codec, `tests/test_audio.py`).

    Events whose recording is absent from ``dir_audio`` (or fails to
    decode) are skipped via ``on_skip(ident, reason)``. Returns the
    written paths.
    """
    import wave as _wave

    from buzzdetect_torch.audio import build_track

    by_ident = {}
    for r in rows:
        by_ident.setdefault(r['ident'], []).append(r)
    paths_audio = _audio_by_ident(dir_audio) if by_ident else {}

    written = []
    for ident, mine in sorted(by_ident.items()):
        path_audio = paths_audio.get(ident)
        if path_audio is None:
            if on_skip is not None:
                on_skip(ident, f'no matching audio under {dir_audio}')
            continue
        try:
            track = build_track(path_audio, target_rate=int(rate or 0))
        except Exception as e:
            if on_skip is not None:
                on_skip(ident, f'cannot decode {path_audio}: {e}')
            continue
        path = None
        try:
            sr = track.samplerate
            # the native stage reports frames < 0 when the container has no
            # duration header (e.g. ADTS AAC) — same guard as
            # audio.get_duration: unknown means unclamped, not negative
            frames = track.frames
            duration_s = frames / sr if frames and frames > 0 else None
            for r in sorted(mine, key=lambda r: (r['start'], r['class'])):
                t0 = max(0.0, float(r['start']) - pad_s)
                t1 = float(r['end']) + pad_s
                if duration_s is not None:
                    t1 = min(t1, duration_s)
                i0 = int(round(t0 * sr))
                n = int(round((t1 - t0) * sr))
                if n <= 0:
                    continue
                name = (f"{ident}_{r['class']}_"
                        f"{r['start']:.2f}-{r['end']:.2f}s.wav")
                path = os.path.join(dir_out, name)
                os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
                track.seek(i0)
                with _wave.open(path, 'wb') as w:
                    w.setnchannels(1)
                    w.setsampwidth(2)
                    w.setframerate(sr)
                    # blockwise: an event can span minutes and the decoder
                    # already hands back int16 in one native pass
                    remaining = n
                    while remaining > 0:
                        block = track.read(min(remaining, 1 << 20),
                                           dtype=np.int16)
                        if not len(block):
                            break  # torn tail: keep what decoded
                        if block.dtype != np.int16:
                            # plugin drivers may ignore the dtype hint and
                            # hand back float32 — quantize like the wire
                            from buzzdetect_torch.utils import quantize_int16
                            block = quantize_int16(block)
                        w.writeframes(block.tobytes())
                        remaining -= len(block)
                if remaining == n:
                    # zero frames decoded: the event lies past the real
                    # audio end (a result file from a since-truncated copy
                    # of a no-duration-header container, where t1 is never
                    # clamped). A 44-byte silent WAV reported as written
                    # would read as a successful export to the reviewer —
                    # remove it and skip loudly instead.
                    os.remove(path)
                    path = None
                    if on_skip is not None:
                        on_skip(ident,
                                f"event {r['class']} "
                                f"{r['start']:.2f}-{r['end']:.2f}s lies "
                                f"past the end of {path_audio}; no audio "
                                f"decoded")
                    continue
                written.append(path)
        except Exception as e:
            # a recording that OPENED but fails mid-export (truncated copy:
            # seek or read raises DecodeError) skips like an unopenable one
            # — the docstring's contract — instead of aborting the export
            # for every recording after it. Complete clips already cut from
            # it stay; the one in flight is removed (a truncated WAV would
            # look like a finished clip to the reviewer).
            if path is not None and path not in written \
                    and os.path.exists(path):
                os.unlink(path)
            if on_skip is not None:
                on_skip(ident, f'decode failed mid-export '
                               f'({path_audio}): {e}')
        finally:
            track.close()
    return written
