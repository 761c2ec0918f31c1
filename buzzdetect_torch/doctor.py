"""Environment self-check: ``python -m buzzdetect_torch.doctor [--json]``.

Verifies everything an analysis run of the port needs — torch, the CUDA
card, the build of the CUDA kernels, audio I/O, the model bundle, and a 1 s
inference on the card — and prints one line per check so field deployments
can triage quickly.

Counterpart of ``buzzdetect_tpu/doctor.py`` with the same ``--json`` schema
(``buzzdetect_doctor/1``: overall ``ok``, per-check results, warnings) and
the same exit codes (0 = all checks passed, 1 = a check failed, 2 = an
unknown flag). The checks follow the port: the CUDA device through
``utils.backend_preflight`` (a watched subprocess, so a hung card cannot
hang the doctor; ``BUZZDETECT_DOCTOR_TIMEOUT`` seconds, default 60),
the ``nvcc`` build and load of every CUDA library, a WAV write/read round
trip, and the native libav decoder with its codec round trip, both skipped
with the reason where ``pkg-config`` finds no FFmpeg. Without a card the
CUDA check fails, the inference is skipped, and the host-side checks still
run.
"""

import json
import os
import sys
import traceback

# The probe is shared with analyze(backend_timeout=...); the module
# attribute exists so tests can substitute another probe.
from buzzdetect_torch.utils import PREFLIGHT_CODE as _PREFLIGHT_CODE
from buzzdetect_torch.utils import backend_preflight


def _backend_reachable(timeout: float):
    """(ok, why_not): dispatch one matmul on the card in a watched
    subprocess."""
    return backend_preflight(timeout, code=_PREFLIGHT_CODE)


# the codec round-trip's codecs, in order of preference: mp3 first, as the
# JAX package's doctor, else the first this machine's FFmpeg encodes
ROUNDTRIP_CODECS = (('libmp3lame', 'mp3'), ('flac', 'flac'),
                    ('libvorbis', 'ogg'), ('pcm_s16le', 'wav'))


def _check(name, fn, results, quiet=False):
    try:
        detail = fn()
        if not quiet:
            print(f'  [ok]   {name}' + (f' — {detail}' if detail else ''))
        results.append({'name': name, 'ok': True, 'detail': detail or ''})
        return True
    except Exception as e:
        err = f'{e.__class__.__name__}: {e}'
        if not quiet:
            print(f'  [FAIL] {name} — {err}')
            if os.environ.get('BUZZDETECT_DOCTOR_TRACE'):
                traceback.print_exc()
        results.append({'name': name, 'ok': False, 'error': err})
        return False


def _skip(name, why, results, quiet=False):
    if not quiet:
        print(f'  [skip] {name} — {why}')
    results.append({'name': name, 'ok': None, 'skipped': True,
                    'detail': why})


def main(modelname: str = None, json_mode: bool = False):
    from buzzdetect_torch import config as cfg
    modelname = modelname or cfg.DEFAULT_MODEL
    results, warnings_out = [], []
    if not json_mode:
        print('buzzdetect-torch doctor')
    ok = True

    def finish():
        if json_mode:
            print(json.dumps({
                'schema': 'buzzdetect_doctor/1',
                'modelname': modelname,
                'ok': ok,
                'warnings': warnings_out,
                'checks': results,
            }))
        elif not ok:
            print('SOME CHECKS FAILED')
        elif warnings_out:
            print('all checks passed — WITH WARNINGS (see above)')
        else:
            print('all checks passed')
        return 0 if ok else 1

    # guarded: a machine where torch itself fails to import is exactly what
    # the doctor exists to triage — it must print a FAIL line, not die with
    # a raw traceback before the first check
    def check_import():
        import torch
        import buzzdetect_torch.models.classifier  # noqa: F401
        return f'torch {torch.__version__} (CUDA {torch.version.cuda})'
    if not _check('torch import', check_import, results, json_mode):
        ok = False
        if not json_mode:
            print('cannot continue without torch; set '
                  'BUZZDETECT_DOCTOR_TRACE=1 for the full traceback')
        return finish()

    try:
        timeout_s = float(os.environ.get('BUZZDETECT_DOCTOR_TIMEOUT', '60'))
    except ValueError:
        # the triage tool must not die on a malformed env var before it
        # has diagnosed anything
        if not json_mode:
            print('WARN  BUZZDETECT_DOCTOR_TIMEOUT is not a number; using 60')
        warnings_out.append('BUZZDETECT_DOCTOR_TIMEOUT is not a number; '
                            'used 60')
        timeout_s = 60.0
    reachable, why = _backend_reachable(timeout_s)
    if reachable:
        def check_cuda():
            import torch
            n = torch.cuda.device_count()
            return f'{n} device(s): {torch.cuda.get_device_name(0)}'
        ok &= _check('CUDA device', check_cuda, results, json_mode)
    else:
        ok = False
        results.append({'name': 'CUDA device', 'ok': False, 'error': why})
        if not json_mode:
            print(f'  [FAIL] CUDA device — {why}')
            print('         skipping device-bound checks; host-side checks '
                  'continue below.\n'
                  '         The port runs on the CPU with device=\'cpu\' '
                  '(CLI: --device cpu).')

    def check_kernels():
        from buzzdetect_torch.ops import _build
        from buzzdetect_torch.ops.common import load_libraries
        load_libraries(_build.SOURCES)
        return ', '.join(f'{name}.cu' for name in _build.SOURCES) + \
            ' built (nvcc) and loaded'
    ok &= _check('CUDA kernels (nvcc build)', check_kernels, results,
                 json_mode)

    def check_wav_roundtrip():
        import tempfile
        import numpy as np
        from buzzdetect_torch.audio import build_track
        from buzzdetect_torch.utils import write_wav
        t = np.arange(8000) / 16000.0
        x = (0.25 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
        with tempfile.TemporaryDirectory() as d:
            p = os.path.join(d, 'probe.wav')
            write_wav(p, x, 16000)
            track = build_track(p, target_rate=16000)
            y = track.read(16000)
            track.close()
        err = float(np.abs(y - x).max())
        if len(y) != len(x) or err > 1.0 / 32768:
            raise RuntimeError(f'read back {len(y)} samples, max error '
                               f'{err:.3g}')
        return f'16 kHz PCM16 WAV write/read round-trip ({len(y)} samples)'
    ok &= _check('WAV round-trip', check_wav_roundtrip, results, json_mode)

    # the native libav stage: skipped where pkg-config finds no FFmpeg (the
    # package then reads PCM16 WAV only), failed where FFmpeg is there and
    # the stage does not build or load
    from buzzdetect_torch.audio import ffi
    try:
        versions = ffi.ffmpeg_versions()
    except ffi.FFmpegNotFound as e:
        versions = None
        for name in ('native decoder (libav)', 'codec round-trip'):
            _skip(name, f'{e}; this machine reads PCM16 WAV only', results,
                  json_mode)

    def check_decoder():
        ffi.get_lib()
        return (f'built and loaded from audio/csrc/buzz_decode.cpp '
                f'(libavcodec {versions["libavcodec"]})')

    def check_decode_roundtrip():
        import tempfile
        from buzzdetect_torch.audio import build_track
        with tempfile.TemporaryDirectory() as d:
            refused = []
            for codec, ext in ROUNDTRIP_CODECS:
                p = os.path.join(d, f'probe.{ext}')
                try:
                    ffi.encode_fixture(p, codec, 16000, 1, 0.5)
                except ffi.DecodeError as e:
                    refused.append(str(e))
                    continue
                t = build_track(p, target_rate=16000)
                n = len(t.read(16000))
                t.close()
                return f'{codec} encode/decode round-trip ({n} samples)'
        raise RuntimeError('this FFmpeg encodes none of '
                           f'{[c for c, _ in ROUNDTRIP_CODECS]}: {refused}')
    if versions is not None:
        ok &= _check('native decoder (libav)', check_decoder, results,
                     json_mode)
        ok &= _check('codec round-trip', check_decode_roundtrip, results,
                     json_mode)

    # metadata only: device='cpu' loads no weights anywhere, so these checks
    # run whether or not the card answers
    def check_model():
        from buzzdetect_torch.models.registry import load_model
        model = load_model(modelname, initialize=False, device='cpu')
        return (f'{modelname}: {len(model.config["classes"])} classes, '
                f'embedder {model.embeddername}')
    ok &= _check('model bundle', check_model, results, json_mode)

    def check_inference():
        import numpy as np
        from buzzdetect_torch.models.registry import load_model
        model = load_model(modelname, initialize=True, device='cuda')
        out = model.predict(np.zeros(16000, np.float32))
        clf = getattr(model, 'classifier', None)
        # report which implementations actually ran: see
        # models/classifier.py for how each knob resolves
        knobs = (f', frontend={clf.frontend}, conv={clf.conv}'
                 f', conv_precision={clf.conv_precision}'
                 f', compute_dtype={str(clf.compute_dtype).split(".")[-1]}'
                 if clf is not None else '')
        return f'1 s inference on the card -> {out.shape} scores{knobs}'
    if reachable:
        ok &= _check('end-to-end inference', check_inference, results,
                     json_mode)
    else:
        _skip('end-to-end inference', 'CUDA device unreachable', results,
              json_mode)

    def check_threshold():
        from buzzdetect_torch.write.thresholds import calculate_threshold
        thr = calculate_threshold(modelname, 0.95)
        return f'precision 0.95 -> threshold {thr:.3f}'
    ok &= _check('threshold calibration (metrics table)', check_threshold,
                 results, json_mode)

    warning = weights_warning(modelname, quiet=json_mode)
    if warning:
        warnings_out.append(warning)

    return finish()


def weights_warning(modelname, quiet=False):
    """WARN when the bundle's provenance says the embedder is untrained.

    A seeded-init embedder makes every downstream number (activations,
    detections, calibrated thresholds) semantically meaningless even though
    the pipeline is numerically healthy — a green doctor without this
    warning would be a false 'ready for the field' light.

    Returns the warning text (for the JSON record), or None."""
    try:
        from buzzdetect_torch.models.registry import load_model
        model = load_model(modelname, initialize=False, device='cpu')
        provenance = model.config.get('provenance', '')
    except Exception:
        return None
    if 'seeded init' not in provenance:
        return None
    if not quiet:
        print(f'  [WARN] UNTRAINED WEIGHTS — bundle provenance says: '
              f'"{provenance}".\n'
              f'         Scores and detections from this bundle are NOT '
              f'meaningful; install pretrained\n'
              f'         weights (tools/fetch_yamnet_weights.py) before field '
              f'use. The packed metrics\n'
              f'         table describes the reference model, not this bundle.')
    return f'UNTRAINED WEIGHTS — bundle provenance: {provenance}'


if __name__ == '__main__':
    argv = sys.argv[1:]
    as_json = '--json' in argv
    # a typo like --jsn must error, not silently fall back to human
    # output with exit 0 — a supervisor would then misread the parse
    # failure of the non-JSON stdout as a broken machine
    unknown = [a for a in argv if a.startswith('--') and a != '--json']
    if unknown:
        print(f"doctor: unknown flag(s): {' '.join(unknown)} "
              f"(supported: --json)", file=sys.stderr)
        sys.exit(2)
    names = [a for a in argv if not a.startswith('--')]
    sys.exit(main(names[0] if names else None, json_mode=as_json))
