#!/usr/bin/env python3
"""Smoke test of the PyTorch port (buzzdetect_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printed before the last line:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the build of both CUDA libraries from ``buzzdetect_torch/csrc``
   (one ``nvcc`` per source, started together);
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (B = 209 patches, one default 200 s chunk; and B = 5), with
   the weights of ``models/model_general_v3/model.npz``: the conv kernels in
   their three modes (exact f32, bf16, emulated HIGH) and the fused log-mel.
   Each row gives max |kernel - plain| against the mode's tolerance, checks
   that two launches agree bit for bit and that the B = 5 rows equal the
   same rows inside B = 209, and gives the median times of the kernel, the
   plain version and one library call for the same function (cuDNN
   ``F.conv2d`` stacks; the matmul frontend for the log-mel), beside the
   least time the card could take (bound). Then one chunk's device time
   stage by stage, with the matmul frontend and with the fused log-mel;
3. the main paths end to end: ``buzzdetect_torch.analyze()`` on three
   30-minute 16 kHz WAV recordings (exact f32), then the CLI in process
   (``buzzdetect_torch.cli.main``) on two 10-minute recordings through a
   temporary models folder (``BUZZDETECT_DIR_MODELS``) that holds
   ``model_general_v3`` and two variants of it whose ``config_model.json``
   differ in one key each: (a) ``--bf16`` with ``"frontend": "pallas"``,
   (b) ``"conv_precision": "high"`` in f32. Each run: end reason, complete
   CSVs with the expected rows, the launch counts of its kernels (set to 0
   just before the run and read just after), one chunk's scores on the card
   against the same chunk on the CPU in the same mode; for the analyze()
   run also the realtime factor and an upper estimate of the device busy
   share;
4. one JSON line with every kernel's numbers.

The last line is ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero with a message, and without a CUDA device the script exits
non-zero before printing any result.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
MODEL = 'model_general_v3'
BATCHES = (209, 5)       # one default 200 s chunk at framehop 1; a ragged B
# exact-f32 arithmetic on both sides (f32, HIGH, log-mel), in a different
# summation order
ATOL, RTOL = 2e-4, 1e-5
# bf16: a one-ulp f32 difference before a layer rounds its input to bf16
# flips that input by one bf16 ulp; bound: 4 ulps of the largest value plus
# 2 ulps relative (tests/test_torch_precision_modes.py)
ULP_BF16 = 2.0 ** -8
SCORE_ATOL = {'highest': 1e-3,   # the score parity budget (BASELINE.md)
              'high': 1e-3,
              'bf16': 5e-3}      # past this a bf16 score is a fault
SOURCES = {'sepconv': 'buzzdetect_torch/csrc/sepconv.cu',
           'logmel': 'buzzdetect_torch/csrc/logmel.cu'}
REPLACES = {'fused_front': 'buzzdetect_tpu/ops/pallas_conv.py:448',
            'fused_tail': 'buzzdetect_tpu/ops/pallas_conv.py:529',
            'log_mel': 'buzzdetect_tpu/ops/pallas_frontend.py:128'}
# the CLI runs: model variant -> (its config key, CLI flags, kernel mode)
VARIANTS = {'model_general_v3_pallas': ({'frontend': 'pallas'}, ['--bf16'],
                                        'bf16'),
            'model_general_v3_high': ({'conv_precision': 'high'}, [],
                                      'high')}


def fail(msg):
    print(f'chip_smoke FAILED: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


def peaks(name):
    """(f32 FLOP/s outside the tensor cores, dense bf16 tensor-core FLOP/s,
    memory bytes/s) from NVIDIA's data sheets, for the card nvidia-smi
    names."""
    if 'H100' not in name:
        fail(f'no peak table for {name!r} (this script targets an H100)')
    if 'PCIe' in name:
        return 51.2e12, 756e12, 2.0e12
    return 67e12, 989e12, 3.35e12   # H100 SXM


def time_ms(torch, fn, reps=15, warmup=3):
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warmup``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def stack_work(specs, b, gap, mode):
    """(pointwise FLOPs, depthwise FLOPs, compulsory bytes) of a sep-layer
    stack at batch b: every multiply-add counted twice (the HIGH mode's
    three bf16 products counted three times), the f32 input read once,
    every weight read once in the mode's type (pointwise: f32, bf16, or two
    bf16 planes), the f32 output written once."""
    pw_flops = dw_flops = n_bytes = 0
    for s in specs:
        pos = b * s.h_out * s.w_out
        pw_flops += 2 * pos * s.c_in * s.c_out * (3 if mode == 'high' else 1)
        dw_flops += 2 * pos * s.c_in * 9
        pw_bytes = 2 if mode == 'bf16' else 4
        n_bytes += 4 * (10 * s.c_in + s.c_out) + pw_bytes * s.c_in * s.c_out
    s0, sl = specs[0], specs[-1]
    out = b * sl.c_out * (1 if gap else sl.h_out * sl.w_out)
    return pw_flops, dw_flops, n_bytes + 4 * (b * s0.h * s0.w * s0.c_in + out)


def bound(t_ops, t_bytes):
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by='operations' if t_ops >= t_bytes else 'bytes')


def library_weights(params, specs, dtype):
    """Per layer (depthwise OIHW, its bias, pointwise OIHW, its bias), in
    the layout and type cuDNN takes; built once, outside the timed region."""
    return [tuple(t.to(dtype) for t in (
        params[f'{s.name}/depthwise_conv/kernel'].t().reshape(
            s.c_in, 1, 3, 3).contiguous(),
        params[f'{s.name}/depthwise_conv/bias'],
        params[f'{s.name}/pointwise_conv/kernel'].t().reshape(
            s.c_out, s.c_in, 1, 1).contiguous(),
        params[f'{s.name}/pointwise_conv/bias'])) for s in specs]


def library_stack(weights, x_nchw, specs, gap):
    """The same layers through cuDNN (F.conv2d for both convs, in the
    weights' type; f32 with TF32 off): the yardstick, timed here only; the
    port never calls it."""
    import torch.nn.functional as F
    from buzzdetect_torch.ops.sepconv import same_pad
    x = x_nchw
    for s, (dw, dwb, pw, pwb) in zip(specs, weights):
        ph, pw_ = same_pad(s.h, s.stride), same_pad(s.w, s.stride)
        x = F.conv2d(F.pad(x, (pw_[0], pw_[1], ph[0], ph[1])), dw, dwb,
                     stride=s.stride, groups=s.c_in).relu_()
        x = F.conv2d(x, pw, pwb).relu_()
    return x.mean(dim=(2, 3)) if gap else x


def write_recording(path, seconds, seed):
    """A 16 kHz mono PCM16 recording: a buzz-like harmonic tone that comes
    and goes, over noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    f0 = 180 + 40 * seed
    tone = sum(0.15 / k * np.sin(2 * np.pi * f0 * k * t) for k in (1, 2, 3))
    gate = (np.sin(2 * np.pi * t / 37.0) > 0.3)
    x = tone * gate + rng.standard_normal(len(t)) * 0.02
    ints = np.clip(np.round(x * 32768), -32768, 32767).astype('<i2')
    with wave.open(path, 'wb') as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(ints.tobytes())


def make_models_dir(root):
    """``root/models``: model_general_v3 (its bundle linked, not copied) and
    the VARIANTS, each a copy whose config_model.json differs in one key."""
    src = os.path.join(ROOT, 'models', MODEL)
    models = os.path.join(root, 'models')
    for name, extra in [(MODEL, {})] + [(n, v[0]) for n, v in
                                        VARIANTS.items()]:
        dst = os.path.join(models, name)
        shutil.copytree(src, dst, ignore=shutil.ignore_patterns('model.npz'))
        os.symlink(os.path.join(src, 'model.npz'),
                   os.path.join(dst, 'model.npz'))
        path = os.path.join(dst, 'config_model.json')
        with open(path) as f:
            config = json.load(f)
        with open(path, 'w') as f:
            json.dump({**config, **extra}, f)
    return models


def check_csvs(dir_out, names, seconds, chunk_s, cfg):
    """Every recording has a complete CSV: the expected rows, 13 finite
    scores each, the time column 0, 0.96, ..."""
    from buzzdetect_torch.ops import frontend
    from buzzdetect_torch.write.coverage import gaps_to_chunklist
    chunks = gaps_to_chunklist([(0.0, seconds)], chunk_s)
    expected = sum(frontend.num_patches(
        int(c1 * 16000) - int(c0 * 16000), cfg) for c0, c1 in chunks)
    for n in names:
        path = os.path.join(dir_out, f'{n}_buzzdetect.csv')
        if not os.path.exists(path):
            fail(f'no complete CSV for {n} in {dir_out}')
        with open(path) as f:
            lines = f.read().splitlines()
        table = np.array([ln.split(',') for ln in lines[1:]], float)
        if table.shape != (expected, 14):
            fail(f'{n}: CSV shape {table.shape}, expected ({expected}, 14)')
        if not np.isfinite(table).all():
            fail(f'{n}: non-finite scores')
        if not np.allclose(table[:, 0], np.round(
                np.arange(expected) * 0.96, 2)):
            fail(f'{n}: time column is not 0, 0.96, 1.92, ...')
    print(f'CSVs: {len(names)} files x {expected} rows x 13 classes, all '
          f'finite; {len(chunks)} chunks of {chunk_s} s per file', flush=True)


def check_chunk_on_cpu(analyzer, arrays, path_audio, path_csv, mode, **kw):
    """One chunk's scores on the card against the same chunk through the
    plain versions on the CPU in the same mode, and the CSV against the
    card's scores."""
    from buzzdetect_torch.audio import build_track
    from buzzdetect_torch.models.classifier import ChunkClassifier
    track = build_track(path_audio)
    samples = track.read_s16(int(analyzer.chunklength * 16000))
    track.close()
    card = analyzer.model.classifier.predict(samples)
    cpu = ChunkClassifier(arrays, device='cpu', transfer_dtype='int16',
                          **kw).predict(samples)
    d = float(np.abs(card - cpu).max())
    print(f'[{mode}] one {analyzer.chunklength} s chunk, card vs CPU: '
          f'{card.shape}, max |dscore| = {d:.3g} (budget '
          f'{SCORE_ATOL[mode]})', flush=True)
    if card.shape != cpu.shape or d > SCORE_ATOL[mode]:
        fail(f'[{mode}] card and CPU scores differ by {d:.3g}')
    with open(path_csv) as f:
        first = np.array([ln.split(',') for ln in
                          f.read().splitlines()[1:]], float)
    if np.abs(first[:len(card), 1:] - np.round(card, 2)).max() > 0.0101:
        fail(f'[{mode}] the CSV does not hold the card\'s scores for chunk 1')


def main():
    import torch
    if not torch.cuda.is_available():
        fail('torch finds no CUDA device')
    if not os.path.isdir(os.path.join(ROOT, 'buzzdetect_torch')):
        fail(f'no buzzdetect_torch package beside {__file__}; run from the '
             f'root of a checkout')
    tmp = tempfile.mkdtemp(prefix='buzz_smoke_')
    try:
        # before the package is imported: config reads it at import
        os.environ['BUZZDETECT_DIR_MODELS'] = make_models_dir(tmp)
        run(torch, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run(torch, tmp):
    sys.path.insert(0, ROOT)
    import buzzdetect_torch
    from buzzdetect_torch import cli
    from buzzdetect_torch.models import yamnet
    from buzzdetect_torch.models.classifier import _classify, _to_float
    from buzzdetect_torch.models.heads import apply_head
    from buzzdetect_torch.models.weights import params_from_numpy
    from buzzdetect_torch.ops import _build, frontend, logmel, sepconv
    from buzzdetect_torch.utils import quantize_int16

    # --- 1. the card and the build ------------------------------------
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'device 0: {kind}, count {torch.cuda.device_count()}', flush=True)
    f32_peak, bf16_peak, bytes_peak = peaks(kind)
    print(f'peaks used for bounds: {f32_peak / 1e12:g} TFLOP/s f32 (no '
          f'tensor cores), {bf16_peak / 1e12:g} TFLOP/s bf16 (tensor cores, '
          f'dense), {bytes_peak / 1e12:g} TB/s', flush=True)
    t0 = time.perf_counter()
    _build.build_all(_build.SOURCES)
    sepconv.load_kernels()
    logmel.load_kernels()
    print(f'built and loaded {", ".join(SOURCES.values())} in '
          f'{time.perf_counter() - t0:.1f} s (one nvcc per source, in '
          f'parallel)', flush=True)

    # --- 2. kernels against their plain versions -----------------------
    sepconv.exact_f32()
    dev = torch.device('cuda')
    with np.load(os.path.join(ROOT, 'models', MODEL, 'model.npz')) as z:
        arrays = {k: z[k] for k in z.files}
    all_params = params_from_numpy(arrays, dev)
    cfg = frontend.FrontendConfig().with_framehop(1.0)
    rows, outputs = {}, {}

    def check_row(name, b, got, ref, again, run_kernel, run_plain,
                  run_library, work, tol):
        """Hold one kernel call against its plain version, time the three,
        print the row; keep it at B=209."""
        err = float((got - ref).abs().max())
        atol, rtol = tol(ref)
        ok = torch.allclose(got, ref, atol=atol, rtol=rtol)
        if not torch.equal(got, again):
            fail(f'{name} B={b}: two launches on the same input differ')
        if b != BATCHES[0] and not torch.equal(
                got, outputs[name][:got.shape[0]]):
            # per-patch results must not depend on the batch
            fail(f'{name}: B={b} rows differ from the same rows inside '
                 f'B={BATCHES[0]}')
        t_ops, t_bytes, flops, n_bytes = work
        row = dict(max_abs_err=err, ms=time_ms(torch, run_kernel),
                   plain_ms=time_ms(torch, run_plain),
                   library_ms=time_ms(torch, run_library),
                   **bound(t_ops, t_bytes))
        torch.cuda.synchronize()
        print(f'kernel {name} B={b}: max |kernel - plain| = {err:.3g} '
              f'(atol {atol:.3g}, rtol {rtol:.3g}); kernel {row["ms"]:.4f} '
              f'ms, plain {row["plain_ms"]:.4f} ms, library '
              f'{row["library_ms"]:.4f} ms, bound {row["bound_ms"]:.4f} ms '
              f'({row["bound_by"]}: {flops / 1e9:.2f} GFLOP, '
              f'{n_bytes / 1e6:.1f} MB)', flush=True)
        if not ok:
            fail(f'{name} B={b} disagrees with its plain version: max |d| '
                 f'{err:.3g}')
        if b == BATCHES[0]:
            outputs[name] = got
            rows[name] = row

    def exact(ref):
        return ATOL, RTOL

    def bf16_scale(ref):
        return 4 * ULP_BF16 * float(ref.abs().max()), 2 * ULP_BF16

    with torch.inference_mode():
        # realistic activations: log-mel patches of one chunk of audio
        # through layer 1 and the plain layers; B = 5 takes the first rows
        b0 = BATCHES[0]
        n = (frontend.min_waveform_samples(cfg)
             + (b0 - 1) * cfg.patch_hop_samples)
        wav = np.random.default_rng(0).standard_normal(n) * 0.1
        wav_dev = torch.from_numpy(wav.astype(np.float32)).to(dev)
        patches = frontend.log_mel_patches(wav_dev, cfg)
        if patches.shape[0] != b0:
            fail(f'expected {b0} patches, framed {patches.shape[0]}')

        # the fused log-mel: B patches are the waveform's first
        # min + (B-1) * hop samples
        for b in BATCHES:
            w = wav_dev[:frontend.min_waveform_samples(cfg)
                        + (b - 1) * cfg.patch_hop_samples]
            n_frames = 1 + (w.shape[0] - 400) // 160
            flops = n_frames * 2 * (400 * 2 * 257 + 257 * 64)
            n_bytes = 4 * (w.shape[0] + n_frames * 64
                           + 400 * 2 * 257 + 257 * 64)
            got = logmel.log_mel_spectrogram_fused(w, cfg)
            torch.cuda.synchronize()
            check_row('log_mel', b, got,
                      logmel.log_mel_spectrogram_fused_plain(w, cfg),
                      logmel.log_mel_spectrogram_fused(w, cfg),
                      lambda: logmel.log_mel_spectrogram_fused(w, cfg),
                      lambda: logmel.log_mel_spectrogram_fused_plain(w, cfg),
                      lambda: frontend.log_mel_spectrogram(w, cfg),
                      (flops / f32_peak, n_bytes / bytes_peak, flops,
                       n_bytes), exact)

        cases = (('fused_front', dict(start_layer=2, stop_layer=8), False),
                 ('fused_tail', dict(start_layer=8, stop_layer=None), True),
                 ('fused_tail[4:8]', dict(start_layer=4, stop_layer=8),
                  False))
        for mode in sepconv.MODES:
            params = sepconv.pack_params(all_params['yamnet'], mode)
            l1 = yamnet.layer1(params, patches, mode)
            inputs = {
                'fused_front': l1,
                'fused_tail': sepconv.fused_front_plain(params, l1, mode=mode)
                .reshape(b0, 6, 4, 512),
                'fused_tail[4:8]': sepconv.fused_front_plain(
                    params, l1, start_layer=2, stop_layer=4, mode=mode)
                .reshape(b0, 24, 16, 128)}
            lib_dtype = torch.bfloat16 if mode == 'bf16' else torch.float32
            for b in BATCHES:
                for base, layers, gap in cases:
                    if mode != 'highest' and base == 'fused_tail[4:8]':
                        continue   # the layer 4-7 row: exact f32 only
                    name = base if mode == 'highest' else f'{base}[{mode}]'
                    x = inputs[base][:b].contiguous()
                    specs = sepconv.tail_specs(layers['start_layer'],
                                               layers['stop_layer'])
                    front = base == 'fused_front'
                    wrapper = sepconv.fused_front if front \
                        else sepconv.fused_tail
                    plain = sepconv.fused_front_plain if front \
                        else sepconv.fused_tail_plain
                    kw = dict(layers, mode=mode) if front \
                        else dict(layers, gap=gap, mode=mode)
                    lib_w = library_weights(params, specs, lib_dtype)
                    x_nchw = x.permute(0, 3, 1, 2).contiguous().to(lib_dtype)
                    pw_f, dw_f, n_bytes = stack_work(specs, b, gap, mode)
                    t_ops = ((pw_f + dw_f) / f32_peak if mode == 'highest'
                             else max(pw_f / bf16_peak, dw_f / f32_peak))
                    got = wrapper(params, x, **kw)
                    torch.cuda.synchronize()
                    check_row(name, b, got, plain(params, x, **kw),
                              wrapper(params, x, **kw),
                              lambda: wrapper(params, x, **kw),
                              lambda: plain(params, x, **kw),
                              lambda: library_stack(lib_w, x_nchw, specs,
                                                    gap),
                              (t_ops, n_bytes / bytes_peak, pw_f + dw_f,
                               n_bytes),
                              bf16_scale if mode == 'bf16' else exact)

        # where one chunk's device time goes, stage by stage, at B = 209,
        # with the matmul frontend and with the fused log-mel
        params = all_params['yamnet']
        l1 = yamnet.layer1(params, patches)
        mid = outputs['fused_front'].reshape(b0, 6, 4, 512)
        wire = torch.from_numpy(quantize_int16(wav.astype(np.float32))).to(dev)
        stages = {
            'frontend': lambda: frontend.log_mel_patches(_to_float(wire), cfg),
            'fused log-mel frontend': lambda: frontend.patches_from_log_mel(
                logmel.log_mel_spectrogram_fused(_to_float(wire), cfg), cfg),
            'layer 1': lambda: yamnet.layer1(params, patches),
            'fused_front': lambda: sepconv.fused_front(params, l1),
            'fused_tail': lambda: sepconv.fused_tail(params, mid),
            'head': lambda: apply_head(all_params['head'],
                                       outputs['fused_tail']),
        }
        stage_ms = {k: time_ms(torch, fn) for k, fn in stages.items()}
        classify_ms = time_ms(torch, lambda: _classify(all_params, wire, cfg))
        pallas_ms = time_ms(torch, lambda: _classify(all_params, wire, cfg,
                                                     'pallas'))
        torch.cuda.synchronize()
        print('one chunk on the card (B=209): ' + ', '.join(
            f'{k} {v:.4f} ms' for k, v in stage_ms.items())
            + f'; whole classify {classify_ms:.4f} ms, with '
            f'frontend=\'pallas\' {pallas_ms:.4f} ms', flush=True)

    # --- 3. the main paths end to end ----------------------------------
    def reset_counts():
        sepconv.fused_front.launches = dict.fromkeys(sepconv.MODES, 0)
        sepconv.fused_tail.launches = dict.fromkeys(sepconv.MODES, 0)
        logmel.log_mel_spectrogram_fused.launches = 0

    def read_counts():
        counts = {'log_mel': logmel.log_mel_spectrogram_fused.launches}
        for fn in (sepconv.fused_front, sepconv.fused_tail):
            for mode, n in fn.launches.items():
                counts[fn.__name__ + ('' if mode == 'highest'
                                      else f'[{mode}]')] = n
        return counts

    launches = {}
    dir_audio = os.path.join(tmp, 'audio')
    os.makedirs(dir_audio)
    seconds = 1800.0
    names = [f'rec{i}' for i in range(3)]
    for i, name in enumerate(names):
        write_recording(os.path.join(dir_audio, f'{name}.wav'), seconds, i)
    dir_out = os.path.join(tmp, 'out')
    reset_counts()
    t0 = time.perf_counter()
    analyzer = buzzdetect_torch.analyze(
        modelname=MODEL, dir_audio=dir_audio, dir_out=dir_out,
        verbosity_print='WARNING')
    wall = time.perf_counter() - t0
    counts = read_counts()
    print(f'analyze: end reason {analyzer.coordinator.end_reason!r}, '
          f'{wall:.2f} s wall, kernel launches {counts}', flush=True)
    if analyzer.coordinator.end_reason != 'completed':
        fail(f'analyze ended {analyzer.coordinator.end_reason!r}')
    for name in ('fused_front', 'fused_tail'):
        if counts[name] <= 0:
            fail(f'the main path never launched {name}')
        launches[name] = counts[name]
    check_csvs(dir_out, names, seconds, analyzer.chunklength, cfg)
    check_chunk_on_cpu(analyzer, arrays, os.path.join(dir_audio, 'rec0.wav'),
                       os.path.join(dir_out, 'rec0_buzzdetect.csv'),
                       'highest')
    audio_s = analyzer.coordinator.audio_seconds_done
    print(f'realtime factor: {audio_s / wall:.1f} audio s per wall s '
          f'({audio_s:.1f} audio s in {wall:.2f} s, model load and warmup '
          f'included)', flush=True)
    # every dispatch is one chunk of at most 209 patches, so this is an
    # upper estimate of the run's device time, from phase 2's time
    dispatches = counts['fused_front']
    busy = dispatches * classify_ms / 1e3
    print(f'device time at most {busy:.3f} s ({dispatches} dispatches x '
          f'{classify_ms:.4f} ms whole classify) of {wall:.2f} s wall: '
          f'device busy share at most {busy / wall:.3f}', flush=True)

    # the CLI, on the model variants
    cli_audio = os.path.join(tmp, 'cli_audio')
    os.makedirs(cli_audio)
    cli_seconds = 600.0
    cli_names = [f'site{i}' for i in range(2)]
    for i, name in enumerate(cli_names):
        write_recording(os.path.join(cli_audio, f'{name}.wav'), cli_seconds,
                        i + 3)
    for variant, (key, flags, mode) in VARIANTS.items():
        out = os.path.join(tmp, f'out_{variant}')
        argv = ['--modelname', variant, '--dir_audio', cli_audio,
                '--dir_out', out, '--verbosity_print', 'WARNING', *flags]
        reset_counts()
        t0 = time.perf_counter()
        result = cli.main(argv)
        wall = time.perf_counter() - t0
        counts = read_counts()
        reason = result.coordinator.end_reason
        print(f'CLI {" ".join(argv[:2] + flags)} ({key}): end reason '
              f'{reason!r}, {wall:.2f} s wall, kernel launches {counts}',
              flush=True)
        if reason != 'completed':
            fail(f'the CLI run of {variant} ended {reason!r}')
        want = [f'fused_front[{mode}]', f'fused_tail[{mode}]']
        if key.get('frontend') == 'pallas':
            want.append('log_mel')
        for name in want:
            if counts[name] <= 0:
                fail(f'the CLI run of {variant} never launched {name}')
            launches[name] = counts[name]
        others = {k: v for k, v in counts.items() if k not in want and v}
        if others:
            fail(f'the CLI run of {variant} launched other kernels: {others}')
        check_csvs(out, cli_names, cli_seconds, result.chunklength, cfg)
        kw = {'compute_dtype': 'bfloat16'} if '--bf16' in flags else {}
        check_chunk_on_cpu(result, arrays,
                           os.path.join(cli_audio, 'site0.wav'),
                           os.path.join(out, 'site0_buzzdetect.csv'), mode,
                           **key, **kw)

    # --- 4. the kernels line ------------------------------------------
    order = ('fused_front', 'fused_tail', 'fused_front[bf16]',
             'fused_tail[bf16]', 'fused_front[high]', 'fused_tail[high]',
             'log_mel')
    table = []
    for name in order:
        r = rows[name]
        base = name.split('[')[0]
        source = SOURCES['logmel' if base == 'log_mel' else 'sepconv']
        table.append({'name': name, 'route': 'cuda', 'source': source,
                      'replaces': REPLACES[base],
                      'launches': launches[name],
                      'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
                      'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
                      'bound_by': r['bound_by'],
                      'library_ms': r['library_ms']})
    print(json.dumps({'kernels': table}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
