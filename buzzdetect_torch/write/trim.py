"""Result-file compaction (the capability of the reference's companion
``buzzr::trim_directory()``, reference `docs/source/result_files.rst:104-107`:
trim to classes of interest, coarsen rounding, store compressed — ~29:1).

Trimmed files are ``<ident>_buzztrim.npz``: a compressed archive holding the
start-time grid as exact scaled integers (the CSV column is rounded to
``digits_time`` decimals, so the integer form is lossless at any recording
length) and one small-integer array per kept class (activations quantized
to ``decimals``).

Copy of ``buzzdetect_tpu/write/trim.py``, import prefix changed.
"""

import os

import numpy as np

from buzzdetect_torch import config as cfg

SUFFIX_TRIMMED = '_buzztrim.npz'


def trim_results(path_csv: str, classes_keep=('ins_buzz',), decimals: int = 1):
    """Load a result CSV and return compacted arrays."""
    if isinstance(classes_keep, str) and classes_keep != 'all':
        # a bare string would do SUBSTRING matching in the `in` test below
        # ('buzz' silently keeping 'ins_buzz'); treat it as one class name
        classes_keep = (classes_keep,)
    # the canonical torn-row-tolerant reader (coverage.read_result_rows):
    # a torn line (e.g. a reference-implementation CSV interrupted
    # mid-append — the two implementations are mutually resumable) must be
    # skipped, not crash the whole trim_directory walk with an IndexError
    from buzzdetect_torch.write.coverage import read_result_rows
    header, rows, _torn = read_result_rows(path_csv)
    if header is None:
        raise ValueError(f'{path_csv} has no usable header; not a result CSV')

    cols = {}
    start_idx = header.index('start')
    starts = np.array([float(r[start_idx]) for r in rows], np.float64)
    for j, name in enumerate(header):
        if not name.startswith(cfg.PREFIX_COLUMN_ACTIVATION) and \
                not name.startswith(cfg.PREFIX_COLUMN_DETECTION):
            continue
        cls = name.split('_', 1)[1]
        if classes_keep != 'all' and cls not in classes_keep:
            continue
        vals = np.array([float(r[j]) for r in rows], np.float64)
        if not np.isfinite(vals).all():
            # int casts of NaN/inf are undefined (x86 yields INT_MIN, which
            # read_trimmed would report as -2e8) — refuse rather than
            # archive garbage and let remove_original delete the truth
            bad = int(np.flatnonzero(~np.isfinite(vals))[0])
            raise ValueError(
                f'{path_csv} column {name} row {bad} holds a non-finite '
                f'activation ({vals[bad]!r}); refusing to quantize it')
        # quantize to a small-int grid: int16 of round(v * 10^decimals);
        # header-only CSVs quantize to an empty int16 column
        q = np.round(vals * (10 ** decimals))
        if q.size == 0 or np.abs(q).max() < 32767:
            cols[name] = q.astype(np.int16)
        else:
            cols[name] = q.astype(np.int32)

    # The CSV start column is rounded to the embedder's digits_time, so
    # every start is an EXACT scaled integer — store it that way. This is
    # precision-exact at any recording length (a float32 grid drifts past
    # the 2-decimal rounding half-step beyond ~36 h — the same failure
    # class fixed in train/embed_corpus) and small integers also compress
    # far better than floats.
    time_decimals = 0
    for r in rows:
        cell = r[start_idx]
        if '.' in cell:
            time_decimals = max(time_decimals,
                                len(cell.split('.', 1)[1].rstrip('0')))
    scaled = np.round(starts * (10 ** time_decimals)).astype(np.int64)
    out = {'starts_scaled': scaled,
           'time_decimals': np.int16(time_decimals),
           'decimals': np.int16(decimals)}
    out.update(cols)
    return out


def read_trimmed(path_npz: str):
    """Trimmed archive -> (starts, {column: float activations})."""
    meta = ('starts', 'starts_scaled', 'time_decimals', 'decimals')
    with np.load(path_npz) as z:
        decimals = int(z['decimals'])
        if 'starts_scaled' in z.files:
            # divide by the integer power rather than multiplying by its
            # inverse: IEEE division is correctly rounded, so the result
            # is bit-identical to float(csv_cell); the multiply double-
            # rounds (14000480 * 0.01 = 140004.80000000002)
            starts = (z['starts_scaled'].astype(np.float64)
                      / float(10 ** int(z['time_decimals'])))
        else:  # archives written before the exact-integer grid
            starts = z['starts'].astype(np.float64)
        scale = 10.0 ** -decimals
        cols = {k: z[k].astype(np.float64) * scale
                for k in z.files if k not in meta}
    return starts, cols


def read_results(path_csv: str):
    """Load a result CSV -> (starts, {column: float array}).

    The reading API downstream analysis needs (the buzzr-style accessor),
    for both activations and detections files.
    """
    from buzzdetect_torch.write.coverage import read_result_rows
    header, rows, _torn = read_result_rows(path_csv)
    if header is None:
        raise ValueError(f'{path_csv} has no usable header; not a result CSV')
    data = np.array([[float(c) for c in r] for r in rows], np.float64)
    if data.size == 0:
        data = data.reshape(0, len(header))
    starts = data[:, header.index('start')]
    cols = {name: data[:, j] for j, name in enumerate(header)
            if name != 'start'}
    return starts, cols


def trim_directory(dir_results: str, classes_keep=('ins_buzz',),
                   decimals: int = 1, remove_original: bool = False,
                   on_skip=None):
    """Compact every finalized result CSV under ``dir_results``.

    Returns (n_files, bytes_before, bytes_after). One bad CSV (no header,
    non-finite values) must not abort a season-scale batch: it is skipped,
    reported through ``on_skip(path, why)``, and its original is NEVER
    removed. Archives write via temp + rename so a crash mid-write cannot
    leave a truncated npz that later aborts detection calling.
    """
    n, before, after = 0, 0, 0
    for root, _dirs, files in os.walk(dir_results):
        for fname in files:
            if not fname.endswith(cfg.SUFFIX_RESULT_COMPLETE):
                continue
            path_csv = os.path.join(root, fname)
            path_out = path_csv[:-len(cfg.SUFFIX_RESULT_COMPLETE)] \
                + SUFFIX_TRIMMED
            path_tmp = path_out + '.tmp.npz'  # savez appends .npz
            try:
                arrays = trim_results(path_csv, classes_keep, decimals)
                np.savez_compressed(path_tmp, **arrays)
                os.replace(path_tmp, path_out)
            except Exception as e:
                # a failed savez (disk full mid-batch) must not leave the
                # half-written temp archive consuming the very space the
                # trim run exists to reclaim
                try:
                    os.remove(path_tmp)
                except OSError:
                    pass
                if on_skip is not None:
                    on_skip(path_csv, str(e))
                continue
            n += 1
            before += os.path.getsize(path_csv)
            after += os.path.getsize(path_out)
            if remove_original:
                os.remove(path_csv)
    return n, before, after
