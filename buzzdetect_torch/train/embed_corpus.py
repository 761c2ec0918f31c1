"""Corpus embedding extraction: audio directory -> per-file embeddings.npz.

Head training (the reference ecosystem's offline step) needs 1024-d YAMNet
embeddings for every frame of a labeled corpus. This reuses the streaming
decode stage and the fused embed graph; output is one compressed npz per
file with the frame-start grid, ready for ``train_head``.

Copy of ``buzzdetect_tpu/train/embed_corpus.py`` with the import prefix
changed, ``audio.driver_map()`` called, and ``embed_directory`` taking the
model's ``device`` (``'cuda'`` unless the caller asks for ``'cpu'``). On
the card ``classifier.embed`` runs layer 1, then the hand kernels
``fused_front`` and ``fused_tail`` (``csrc/sepconv.cu``): one launch of
each per chunk.
"""

import os

import numpy as np

from buzzdetect_torch import config as cfg
from buzzdetect_torch.audio import build_track, get_duration
from buzzdetect_torch.utils import build_ident, search_dir
from buzzdetect_torch.write.coverage import gaps_to_chunklist

SUFFIX_EMBEDDINGS = '_embeddings.npz'


def embed_file(classifier, path_audio: str, chunklength: float = 200.0):
    """One audio file -> (starts, embeddings) at the classifier's framehop."""
    cfg_fe = classifier.cfg
    framehop_s = cfg_fe.patch_hop_seconds
    # round to whole frames exactly like Analyzer._setup_chunklength: an
    # unrounded boundary puts the final patch window past the chunk's end
    # (scored against zero padding where real audio exists in the NEXT
    # chunk) and restarts the start grid off-stride every chunk
    fl = cfg_fe.patch_window_seconds
    chunklength = max(round(chunklength / fl) * fl, fl)
    track = build_track(path_audio, target_rate=cfg_fe.sample_rate)
    try:
        duration = get_duration(track)
        chunks = gaps_to_chunklist([(0.0, duration)], chunklength)
        all_emb, all_starts = [], []
        for t0, t1 in chunks:
            rate = track.samplerate
            sample_from = int(t0 * rate)
            # int(t1*rate) - int(t0*rate), NOT int((t1-t0)*rate): the
            # pipeline streamer computes chunk sample spans this way
            # (runtime/streamer.py queue_chunk), and the two disagree by
            # one sample on non-frame-aligned boundaries — the final patch
            # would embed one zero-padded sample where analyze() saw real
            # audio, breaking score_embeddings' byte-parity contract on
            # any recording longer than one chunk
            read_size = int(t1 * rate) - sample_from
            track.seek(sample_from)
            samples = track.read(read_size)
            if len(samples) == 0:
                break
            emb = classifier.embed(samples)
            all_emb.append(emb)
            all_starts.append(t0 + np.arange(len(emb)) * framehop_s)
            if len(samples) < read_size:
                break  # truncated audio
        if not all_emb:
            return np.zeros(0), np.zeros((0, 1024), np.float32)
        return (np.concatenate(all_starts),
                np.concatenate(all_emb).astype(np.float32))
    finally:
        track.close()


def embed_directory(dir_audio: str, dir_out: str, modelname: str = None,
                    framehop_prop: float = 1.0, chunklength: float = 200.0,
                    log=print, device='cuda'):
    """Embed every supported audio file under ``dir_audio``.

    Writes ``<ident>_embeddings.npz`` (keys: starts, embeddings) under
    ``dir_out`` and returns the list of written paths. Already-embedded
    files are skipped (same resumability contract as analysis — including
    the settings pin: a manifest records the model and framehop these
    embeddings were produced under, and a rerun with different settings
    fails loudly instead of silently adopting stale npz files whose starts
    grid no longer matches).
    """
    import json
    from buzzdetect_torch.audio import driver_map
    from buzzdetect_torch.models.registry import load_model

    settings = {'model': modelname or cfg.DEFAULT_MODEL,
                'framehop_prop': framehop_prop}
    path_manifest = os.path.join(dir_out, 'embeddings_manifest.json')
    if os.path.exists(path_manifest):
        with open(path_manifest) as f:
            prior = json.load(f)
        if prior != settings:
            raise ValueError(
                f'{dir_out} holds embeddings produced with {prior}, which '
                f'conflicts with the requested {settings}; embed into a '
                f'fresh dir_out (or delete the stale one) instead of '
                f'mixing incompatible embedding grids')
    else:
        os.makedirs(dir_out, exist_ok=True)
        # A dir_out that already holds embedding npz files but no manifest
        # predates the settings pin (or lost it). Writing a fresh manifest
        # here would certify those files as matching the *requested*
        # settings — the exact silent grid-mixing the pin exists to
        # prevent — so refuse instead of adopting.
        orphans = [os.path.join(root, name)
                   for root, _dirs, names in os.walk(dir_out)
                   for name in names if name.endswith(SUFFIX_EMBEDDINGS)]
        if orphans:
            raise ValueError(
                f'{dir_out} holds {len(orphans)} embedding file(s) (e.g. '
                f'{os.path.basename(orphans[0])}) but no '
                f'embeddings_manifest.json recording the settings they '
                f'were produced under; cannot verify they match the '
                f'requested {settings}. Embed into a fresh dir_out, or — '
                f'if you are certain they match — restore the manifest '
                f'by hand.')
        with open(path_manifest, 'w') as f:
            json.dump(settings, f)

    # lazy: a fully-resumed corpus (every npz present) must not pay the
    # model load / device placement just to skip every file
    classifier = None

    def get_classifier():
        nonlocal classifier
        if classifier is None:
            model = load_model(modelname or cfg.DEFAULT_MODEL,
                               framehop_prop=framehop_prop, initialize=True,
                               device=device)
            classifier = model.classifier
        return classifier

    if os.path.isfile(dir_audio):
        # a single recording instead of a directory — same quality-of-life
        # superset as analyze(dir_audio=<file>) (analysis.py:461-467):
        # root = its parent so the ident is the basename. abspath BOTH
        # sides: build_ident's containment check compares path prefixes,
        # so a relative file against an absolute root would leak the
        # directory into the ident (breaking parity with analyze())
        dir_audio = os.path.abspath(dir_audio)
        from buzzdetect_torch.utils import get_ext
        if get_ext(dir_audio) not in driver_map():
            # fatal, not the per-file isolation below: an unsupported
            # extension can never heal, and the isolation path would
            # reduce it to a log line + "embedded 0 files"
            raise ValueError(
                f'unsupported audio format {get_ext(dir_audio)!r}: '
                f'{dir_audio}')
        root = os.path.dirname(dir_audio) or '.'
        paths = [dir_audio]
    else:
        root = dir_audio
        paths = search_dir(dir_audio, list(driver_map()))

    written = []
    for path in paths:
        ident = build_ident(path, root)
        path_out = os.path.join(dir_out, ident + SUFFIX_EMBEDDINGS)
        if os.path.exists(path_out):
            continue
        try:
            if os.path.getsize(path) < cfg.FILE_SIZE_MINIMUM:
                log(f'skipping {ident}: below minimum analyzeable size')
                continue
            os.makedirs(os.path.dirname(path_out) or '.', exist_ok=True)
            starts, embeddings = embed_file(get_classifier(), path,
                                            chunklength)
            # write-then-rename: the skip-if-exists resume above must never
            # adopt a truncated npz left by a mid-write crash
            # starts stay float64: analyze() derives its start column from
            # a float64 grid, and float32 spacing passes the 0.005
            # half-step of digits_time=2 rounding beyond t ~ 131072 s
            # (~36 h) — a downcast would break score_embeddings' byte
            # parity exactly on the days-long recordings the framework
            # advertises
            path_tmp = path_out + '.tmp.npz'  # savez appends .npz otherwise
            np.savez_compressed(path_tmp, starts=starts.astype(np.float64),
                                embeddings=embeddings)
            os.replace(path_tmp, path_out)
            written.append(path_out)
            log(f'embedded {ident}: {len(embeddings)} frames')
        except Exception as e:
            # one corrupt file must not abort the corpus (the analysis
            # pipeline isolates such files the same way); reruns retry it
            log(f'ERROR embedding {ident}: {e}; skipping this file')
    return written


def load_embeddings(path_npz: str):
    with np.load(path_npz) as z:
        return z['starts'], z['embeddings']
