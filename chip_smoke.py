#!/usr/bin/env python3
"""Smoke test of the PyTorch port (buzzdetect_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printed before the last line:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the build of the three CUDA libraries from ``buzzdetect_torch/csrc``
   (``sepconv``, ``logmel``, ``probe``; one ``nvcc`` per source, started
   together); then the ``decoder:`` line: the FFmpeg libraries that
   ``pkg-config`` finds, or their absence, and ``audio.ffi.native_status()``
   (a native stage that fails to build where FFmpeg is present fails the
   run);
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (B = 209 patches, one default 200 s chunk; and B = 5), with
   the weights of ``models/model_general_v3/model.npz``: the conv kernels in
   their three modes (exact f32, bf16, emulated HIGH) and the fused log-mel
   (with the geometry each of its launches takes: frames per cluster,
   cluster size, blocks, and ``cudaOccupancyMaxActiveClusters``). Each row
   gives max |kernel - plain| against the mode's tolerance, checks that two
   launches agree bit for bit and that the B = 5 rows equal the
   same rows inside B = 209, and gives the median times of the kernel, the
   plain version and one library call for the same function (cuDNN
   ``F.conv2d`` stacks; the matmul frontend for the log-mel), their ratio,
   and the least time the card could take (bound), and the kernel's and
   the library's device time alone (``torch.profiler``), since the
   CUDA-event times include the host's launches. A conv row also names the
   unit its layers' pointwise product runs on (FFMA in exact f32, the
   tensor cores in bf16 and HIGH). Then each mode's device time layer by
   layer with its bound,
   the exact-f32 FFMA kernel's against the cuDNN layer's (TF32 off), the
   ratio of the bf16 and HIGH kernels' to the exact-f32 kernel's, and one
   chunk's device time stage by stage, with the matmul frontend and with
   the fused log-mel;
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
4. the developer tools (``buzzdetect_torch/tools``): (a) the capability
   probe's 23 cases through the kernels of ``csrc/probe.cu`` (launch counts
   set to 0 just before and read just after; its 20 layout cases are one
   ``remap`` launch); (b) ``remap_batch`` on the 20 layout cases in one
   launch, beside the per-case path (20 launches) and one PyTorch call per
   case (``remap_library``), by CUDA events and device time, and
   the three product kernels at the probe's shape and at
   the conv tail's pointwise shapes (B = 209: 5016 x 512 x 512 with layer
   8's input and weight, 1254 x 1024 x 1024 with layer 14's), each against
   its plain version, twice for bit-identity, timed beside its plain
   version, ``torch.matmul`` in f32 and its bound, each row naming the
   unit that runs its product (FFMA or the tensor cores) and giving its
   and ``torch.matmul``'s device time alone (``torch.profiler``); then the
   two HIGH
   routes against float64 on standard-normal operands at the tail's two
   shapes, within a bound that one bf16 pass would exceed; and each
   product's, ``torch.matmul``'s and the log-mel's host launch work (CUDA
   events less device time); (c) ``analyze(
   profile_dir=)`` on one 60 s recording, beside one run without the
   profiler: the trace must name the conv kernels; its five longest device
   operations and the CPU ops per thread;
   (d) the stack sampler of ``tools/profile_pipeline.py`` around one
   ``analyze()`` of phase 3's recordings; (e) ``tools/roofline.py`` for one
   200 s chunk with peaks measured on the card, then its FMA chain kernel
   against its plain version;
5. native rates: the on-device resampler (``ops/resample.py``) on one
   200 s chunk at 44.1 and 48 kHz against the port's CPU resample (atol
   1e-5), with its CUDA-event time, its device time and its conv's alone
   (``torch.profiler``), each beside its bounds from the shapes (the
   function's nonzero taps, and every tap of the kernel as laid out); then
   ``analyze(resample_on_device=True)`` in exact f32 on two 600 s PCM16
   WAVs, 48 kHz stereo and 44.1 kHz mono: end reason, CSV rows, the conv
   kernels' launch counts, one 200 s chunk of each file on the card against
   the CPU, and the run again under the stack sampler. Where the native
   libav stage is present, also the same files
   through host resampling under the stack sampler (quantize and read
   shares), a FLAC made by ``encode_fixture`` at 48 kHz, and
   ``decode_rate_probe`` for pcm, flac and mp3; where it is absent, one
   line saying why those did not run;
6. the XLA conv path and the layouts that need no collective: (a)
   ``ChunkClassifier(conv='xla')`` on one 200 s chunk of phase 3's first
   recording, at its 'auto' precision ('high', exact f32 here) and in bf16:
   card against CPU, the hand conv kernels' launch counts over the call
   (all must be 0), and at B = 209 the conv stack's CUDA-event and device
   time beside the hand kernels' (layer 1 + ``fused_front`` +
   ``fused_tail``) and the whole classify beside the kernel path's; (b) the
   CLI on a bundle variant whose config says ``"conv": "xla"`` and on
   ``model_general_v3``, on phase 3's two CLI recordings: end reasons,
   realtime factor, no hand-kernel launch on the XLA run, one chunk card
   against CPU, the two runs' CSVs equal after 2-digit rounding; (c)
   ``analyze(devices=['cuda:0', 'cuda:0'])`` (two replicas, each with its
   own dispatch thread and CUDA stream) on phase 3's recordings: CSVs
   byte-identical to phase 3's, realtime factor; (d) two concurrent
   ``python -m buzzdetect_torch --host_shard I/2`` processes on one shared
   output folder: both exit 0 and the union of their CSVs is
   byte-identical to phase 3's;
7. training and writers, at the full width of ``model_general_v3`` on a
   seeded corpus (4 x 120 s 16 kHz PCM16 WAVs named as AudioMoth-style
   stations, tone-burst ``ins_buzz`` and noise-only ``ambient_noise``
   events, their annotation CSV), in the temporary models folder, with
   ``--no-report``: (a) ``buzzdetect_torch.tools.train_model`` head-only
   for 5 epochs: the conv kernels' launches over it, which must equal one
   ``fused_front`` and one ``fused_tail`` per chunk embedded, one file's
   embeddings card against CPU, the losses and stage times (the tool's
   own lines) and the bundle's metrics table; (b) ``train_model --full``
   (batch 32 of 0.975 s clips, 2 epochs): one train step's CUDA-event and
   device time beside its bound from its operations, the first step's
   loss and per-leaf gradients card against CPU from one state, each
   held leaf by leaf to float64 along its own run's ReLU branches, the
   resume test (1 epoch, then a resume to 2, against the tool's 2
   straight, bit for bit) and one ``--augment`` step's loss; (c)
   ``analyze()`` with both trained bundles on one recording, on the card
   and on the CPU, then ``call_detections`` (CSV, Audacity, Raven, event
   clips), ``activity_report`` and ``trim_results`` on each run's CSVs,
   here and in a process without a card: their outputs byte-identical
   between the processes, and card against CPU where the CSVs are;
8. one JSON line with every kernel's numbers.

The last line is ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero with a message, and without a CUDA device the script exits
non-zero before printing any result.
"""

import collections
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
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
           'logmel': 'buzzdetect_torch/csrc/logmel.cu',
           'probe': 'buzzdetect_torch/csrc/probe.cu'}
REPLACES = {'fused_front': 'buzzdetect_tpu/ops/pallas_conv.py:448',
            'fused_tail': 'buzzdetect_tpu/ops/pallas_conv.py:529',
            'log_mel': 'buzzdetect_tpu/ops/pallas_frontend.py:128',
            'remap': 'tools/mosaic_capability_probe.py:49',
            'dot_f32': 'tools/mosaic_capability_probe.py:152',
            'dot_high': 'tools/mosaic_capability_probe.py:270',
            'dot_high_emulated': 'tools/mosaic_capability_probe.py:289',
            # the jitted FMA chain of the JAX roofline's measure_peaks (XLA,
            # not a Pallas kernel): the f32 peak probe of tools/roofline.py
            'fma_chain': 'tools/roofline.py:157'}
# the units that run the conv kernels' pointwise product
# (sepconv.layer_route)
PRODUCT_UNITS = {'mma': 'the tensor cores (mma)', 'ffma': 'FFMA'}
# the product kernels of csrc/probe.cu, and the unit each runs on
DOTS = ('dot_f32', 'dot_high', 'dot_high_emulated')
DOT_UNITS = {'dot_f32': 'ffma', 'dot_high': 'mma', 'dot_high_emulated': 'mma'}
# the length of the recording analyze(profile_dir=) traces in phase 4
PROFILED_SECONDS = 60.0
# the two HIGH routes against float64 of their common function on
# standard-normal operands, at K = 512 and 1024 (values up to ~160): the
# tensor cores' f32 accumulation in one accumulator (dot_high) read a max
# |error| of 6.2e-4 at K = 1024, the three products in order on FFMA
# 3.2e-4, cuBLAS f32 4.3e-5 (NVIDIA H100 80GB HBM3, 700 W); one bf16 pass
# (hi*hi alone) errs by ~0.1, so the check can tell them apart
HIGH_F64_ATOL = 2e-3
# the FMA chain against its float64 plain version: the map contracts
# towards 1, so the running value stays within max(|x|, 1); 1024 roundings
# of at most half an f32 ulp of it give |kernel - plain| <= 1024 * 2**-24
# = 6.1e-5 of max(|x|, 1) per element, checked as FMA_RTOL * max(|x|, 1)
FMA_RTOL = 1e-4
# the CLI runs: model variant -> (its config key, CLI flags, kernel mode)
VARIANTS = {'model_general_v3_pallas': ({'frontend': 'pallas'}, ['--bf16'],
                                        'bf16'),
            'model_general_v3_high': ({'conv_precision': 'high'}, [],
                                      'high')}

# the native-rate phase: its recordings, (rate, channels) each, PCM16 WAV of
# NATIVE_SECONDS; the FLAC of the native stage's part, and the seconds of
# each decode_rate_probe fixture
NATIVE_RECORDINGS = ((48000, 2), (44100, 1))
NATIVE_SECONDS = 600.0
FLAC_SECONDS = 120.0
PROBE_CODECS = ('pcm_s16le', 'flac', 'libmp3lame')
PROBE_SECONDS = 60.0
# the resampler on the card against the port's CPU resample: the same f32
# products summed in another order (tests/test_torch_resample.py reads
# ~1e-6 against the JAX resampler)
RESAMPLE_ATOL = 1e-5
# the resampler's timed input: one default chunk at each native rate
RESAMPLE_RATES = (44100, 48000)
RESAMPLE_SECONDS = 200.0
# the XLA conv path (conv='xla'): the bundle variant whose config asks for
# it, and the modes phase 6 runs it in: 'auto' precision (-> 'high', exact
# f32 on the card) and bf16, each with its classifier keywords
XLA_BUNDLE = ('model_general_v3_xla', {'conv': 'xla'})
XLA_MODES = {'high': {}, 'bf16': {'compute_dtype': 'bfloat16'}}
# two replicas on the one card (analyze(devices=...)), and the time limit of
# each host_shard child process
REPLICA_DEVICES = ['cuda:0', 'cuda:0']
HOST_TIMEOUT = 600
# phase 7, training and writers: the seeded corpus (CORPUS_FILES PCM16 WAVs
# of CORPUS_SECONDS at 16 kHz, each with CORPUS_EVENTS tone bursts), its
# classes, and the fine-tune's batch and epochs
CORPUS_FILES = 4
CORPUS_SECONDS = 120.0
CORPUS_EVENTS = 8
TRAIN_CLASSES = ['ins_buzz', 'ambient_noise']
FULL_BATCH = 32
FULL_EPOCHS = 2
HEAD_EPOCHS = 5
# embeddings, card against CPU: exact f32 on both sides in another summation
# order (tests/test_torch_train.py reads the port's CPU embeddings within
# 1.1e-6 of a float64 evaluation), held to 1e-5 of the largest |embedding|
EMB_RTOL = 1e-5
# first-step gradients, as a share of each leaf's max |g|, against a float64
# evaluation that takes the same ReLU branches as the f32 run it referees:
# f32 rounding (the CPU port: 2.1e-5 largest, 5.1e-6 median over the 56
# leaves on this corpus). Against float64's own branches an f32 gradient
# differs wherever a pre-activation within rounding of 0 takes the other
# branch (the CPU port: 8 such elements, all at |z| <= 8.2e-6, and one of
# them, layer10/depthwise_conv's channel 222, puts 7.4e-2 on
# layer9/pointwise_conv/kernel's column 222); so each branch the f32 run
# takes against float64's lies within BRANCH_EDGE of 0
GRAD_RTOL = 1e-4
BRANCH_EDGE = 1e-4


def fail(msg):
    print(f'chip_smoke FAILED: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


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


def remap_bytes(torch, case, inputs, out):
    """Compulsory bytes of one ``remap`` case: the 32-byte sectors of the
    input that its output maps from (masked rows and dropped rows or lanes
    are never loaded; the other inputs' elements each at most once), all of
    both inputs of ``outer_broadcast_mul``, and the output written once."""
    from buzzdetect_torch.ops import probe
    if len(inputs) > 1:
        read = 4 * sum(t.numel() for t in inputs)
    else:
        # the plain version on 1, 2, ... in the input's place gives each
        # output element's source offset + 1, or 0 where nothing is read
        x = inputs[0]
        src = probe.remap_plain(case, torch.arange(
            1, x.numel() + 1, dtype=torch.float32,
            device=x.device).reshape(x.shape))
        offsets = src[src > 0].long() - 1
        read = 32 * torch.unique(offsets * 4 // 32).numel()
    return read + 4 * out.numel()


def remap_library(torch, cases):
    """For each of the 20 layout cases, one PyTorch call that makes the same
    tensor as ``remap`` in new memory: ``torch.mul``; ``F.pad`` of the
    sliced input for the pad-shifts; ``masked_fill`` for the masks, which
    are built outside the timed call; the case's own expression where it
    already makes new memory (``torch.roll``, a reshape that copies); else
    the one copy that turns the case's view into a tensor of its own
    (``contiguous``, or ``clone`` where the view is already contiguous)."""
    import torch.nn.functional as F
    from buzzdetect_torch.ops import probe
    calls = []
    for name, ts in cases:
        x, f = ts[0], probe.CASES[name]
        if name == 'outer_broadcast_mul':
            calls.append(lambda x=x, w=ts[1]: torch.mul(x, w))
        elif name == 'pad_slice_shift':
            calls.append(lambda x=x: F.pad(x[:, :-1, :], (0, 0, 1, 0)))
        elif name == 'pad_slice_lane':
            calls.append(lambda x=x: F.pad(x[:, :, :-1], (1, 0)))
        elif name.startswith('iota'):
            mask = f(torch.ones_like(x)) == 0
            calls.append(lambda x=x, m=mask: x.masked_fill(m, 0.0))
        elif (f(x).untyped_storage().data_ptr()
              != x.untyped_storage().data_ptr()):
            calls.append(lambda x=x, f=f: f(x))
        elif f(x).is_contiguous():
            calls.append(lambda x=x, f=f: f(x).clone())
        else:
            calls.append(lambda x=x, f=f: f(x).contiguous())
    return calls


def bound(t_ops, t_bytes):
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by='operations' if t_ops >= t_bytes else 'bytes')


def write_recording(path, seconds, seed, rate=16000, channels=1):
    """A PCM16 recording (16 kHz mono unless asked otherwise): a buzz-like
    harmonic tone that comes and goes, over noise, independent in each
    channel."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    f0 = 180 + 40 * seed
    tone = sum(0.15 / k * np.sin(2 * np.pi * f0 * k * t) for k in (1, 2, 3))
    gate = (np.sin(2 * np.pi * t / 37.0) > 0.3)
    noise = rng.standard_normal(len(t) if channels == 1
                                else (len(t), channels))
    x = ((tone * gate)[:, None] if channels > 1 else tone * gate) \
        + noise * 0.02
    ints = np.clip(np.round(x * 32768), -32768, 32767).astype('<i2')
    with wave.open(path, 'wb') as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(ints.tobytes())


def make_models_dir(root):
    """``root/models``: model_general_v3 (its bundle linked, not copied),
    the XLA_BUNDLE and the VARIANTS, each a copy whose config_model.json
    differs in one key."""
    src = os.path.join(ROOT, 'models', MODEL)
    models = os.path.join(root, 'models')
    for name, extra in [(MODEL, {}), XLA_BUNDLE] + [
            (n, v[0]) for n, v in VARIANTS.items()]:
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


def check_csvs(dir_out, names, seconds, chunk_s, cfg, rate=16000):
    """Every recording has a complete CSV: the expected rows, 13 finite
    scores each, the time column 0, 0.96, ... A recording at another
    ``rate`` is cut into chunks at that rate, each resampled to 16 kHz."""
    from buzzdetect_torch.ops import frontend
    from buzzdetect_torch.write.coverage import gaps_to_chunklist
    chunks = gaps_to_chunklist([(0.0, seconds)], chunk_s)
    expected = sum(frontend.num_patches(
        -(-(int(c1 * rate) - int(c0 * rate)) * 16000 // rate), cfg)
        for c0, c1 in chunks)
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


def check_chunk_on_cpu(analyzer, arrays, path_audio, path_csv, mode,
                       input_rate=None, **kw):
    """One chunk's scores on the card against the same chunk through the
    plain versions on the CPU in the same mode, and the CSV against the
    card's scores. With ``input_rate`` the chunk is read at that native
    rate and resampled on each device."""
    from buzzdetect_torch.audio import build_track
    from buzzdetect_torch.models.classifier import ChunkClassifier
    track = build_track(path_audio, target_rate=0 if input_rate else 16000)
    samples = track.read_s16(int(analyzer.chunklength
                                 * (input_rate or 16000)))
    track.close()
    card = analyzer.model.classifier.predict(samples, input_rate=input_rate)
    cpu = ChunkClassifier(arrays, device='cpu', transfer_dtype='int16',
                          **kw).predict(samples, input_rate=input_rate)
    d = float(np.abs(card - cpu).max())
    print(f'[{mode}] one {analyzer.chunklength} s chunk'
          + (f' at {input_rate} Hz' if input_rate else '')
          + f', card vs CPU: {card.shape}, max |dscore| = {d:.3g} (budget '
          f'{SCORE_ATOL[mode]})', flush=True)
    if card.shape != cpu.shape or d > SCORE_ATOL[mode]:
        fail(f'[{mode}] card and CPU scores differ by {d:.3g}')
    with open(path_csv) as f:
        first = np.array([ln.split(',') for ln in
                          f.read().splitlines()[1:]], float)
    if np.abs(first[:len(card), 1:] - np.round(card, 2)).max() > 0.0101:
        fail(f'[{mode}] the CSV does not hold the card\'s scores for chunk 1')


def decoder_line():
    """Print what decodes audio here: the FFmpeg that pkg-config finds (or
    its absence) and ``native_status()``. A native stage that does not
    build where FFmpeg is present fails the run. Returns native_status()."""
    from buzzdetect_torch.audio import ffi
    try:
        found = ', '.join(f'{k} {v}' for k, v in
                          ffi.ffmpeg_versions().items())
    except ffi.FFmpegNotFound as e:
        found = None
        absent = str(e)
    ok, why = ffi.native_status()
    print(f'decoder: pkg-config FFmpeg: {found or "absent: " + absent}; '
          f'native_status() = ({ok}, {why.splitlines()[0]!r})', flush=True)
    if found and not ok:
        fail(f'FFmpeg is present but the native decode stage does not '
             f'build:\n{why}')
    return ok, why


def sampler_shares(sampler):
    """Percent of all stack samples (wall x threads) in the streamers'
    wire quantizer and in their audio reads (the rest of a read)."""
    def share(match):
        hits = sum(n for (role, ours, leaf), n in sampler.busy.items()
                   if role == 'streamer' and match(ours, leaf))
        return 100 * hits / max(1, sampler.total)
    return (share(lambda ours, leaf: 'quantize' in ours + leaf),
            share(lambda ours, leaf: 'quantize' not in ours + leaf
                  and ours.split(':')[-1].startswith('read')))


def resampler_phase(torch, dev, f32_peak, bytes_peak, time_ms, device_ms,
                    seconds=RESAMPLE_SECONDS):
    """The on-device resampler on one chunk at each of RESAMPLE_RATES:
    card against the port's CPU resample, its CUDA-event time and device
    time, the conv's device time alone, each beside its bounds: the
    function's (its nonzero taps) and the layout's (every tap of the
    (up, 1, W) kernel), with the bytes of the f32 input and output."""
    import importlib
    from math import gcd
    import torch.nn.functional as F
    rs = importlib.import_module('buzzdetect_torch.ops.resample')
    gen = torch.Generator(device=dev).manual_seed(8)
    for rate in RESAMPLE_RATES:
        n = int(seconds * rate)
        x = torch.randn(n, device=dev, generator=gen) * 0.1
        with torch.inference_mode():
            got = rs.resample(x, rate, 16000)
            ref = rs.resample(x.cpu(), rate, 16000)
        err = float((got.cpu() - ref).abs().max())
        g = gcd(rate, 16000)
        up, down = 16000 // g, rate // g
        K, i0_min, width = rs._polyphase_kernel(up, down, 16)
        n_out = got.numel()
        n_m = -(-n_out // up)
        macs, useful = n_m * up * width, n_m * int(np.count_nonzero(K))
        n_bytes = 4 * (n + n_out)
        b_fn = bound(2 * useful / f32_peak, n_bytes / bytes_peak)
        b_lay = bound(2 * macs / f32_peak, n_bytes / bytes_peak)
        pad_hi = max(0, (n_m - 1) * down + width - (n - i0_min))
        lhs = F.pad(x.reshape(1, 1, n), (-i0_min, pad_hi))
        kd = rs._device_kernel(up, down, 16, dev)

        def run():
            return rs.resample(x, rate, 16000)

        def conv():
            with rs._no_tf32():
                return F.conv1d(lhs, kd, stride=down)
        print(f'resample {rate} -> 16000 Hz, one {seconds:g} s chunk ({n} '
              f'samples; kernel {up}x1x{width}, stride {down}, '
              f'{macs / 1e9:.3f} G MAC as laid out, {useful / 1e9:.3f} G '
              f'useful, {n_bytes / 1e6:.1f} MB): max |card - CPU| = '
              f'{err:.3g} (atol {RESAMPLE_ATOL}); CUDA events '
              f'{time_ms(run):.4f} ms, device time {device_ms(run):.4f} ms '
              f'(the conv alone {device_ms(conv):.4f} ms); bound '
              f'{b_fn["bound_ms"]:.4f} ms ({b_fn["bound_by"]}) for the '
              f'useful taps, {b_lay["bound_ms"]:.4f} ms '
              f'({b_lay["bound_by"]}) as laid out', flush=True)
        if not err <= RESAMPLE_ATOL:
            fail(f'resample {rate} Hz: card and CPU differ by {err:.3g}')


def native_rate_phase(tmp, arrays, cfg, native, reset_counts, read_counts,
                      seconds=NATIVE_SECONDS, device='cuda'):
    """This slice's path: analyze(resample_on_device=True) on native-rate
    PCM16 WAVs (NATIVE_RECORDINGS), in exact f32 on ``device``: end reason,
    CSV rows, the conv kernels' launch counts (set to 0 just before and
    read just after), one chunk of each file on the card against the CPU;
    then the same run again under the stack sampler (quantize and read
    shares). Where the native stage is present (``native`` = native_status()),
    also the same files through host resampling (same CSV shapes, under
    the stack sampler), a FLAC made by encode_fixture, and
    decode_rate_probe; else one line saying why those did not run."""
    import buzzdetect_torch
    from buzzdetect_torch.tools import profile_pipeline
    dir_audio = os.path.join(tmp, 'native_audio')
    os.makedirs(dir_audio)
    names = {}
    for i, (rate, channels) in enumerate(NATIVE_RECORDINGS):
        name = f'native{rate // 1000}k{channels}'
        names[name] = rate
        write_recording(os.path.join(dir_audio, f'{name}.wav'), seconds,
                        6 + i, rate=rate, channels=channels)
    audio_s = seconds * len(names)

    def analyze(out, on_device, where=dir_audio):
        t0 = time.perf_counter()
        result = buzzdetect_torch.analyze(
            modelname=MODEL, dir_audio=where, dir_out=out, device=device,
            verbosity_print='WARNING', resample_on_device=on_device)
        wall = time.perf_counter() - t0
        if result.coordinator.end_reason != 'completed':
            fail(f'analyze(resample_on_device={on_device}) on {where} ended '
                 f'{result.coordinator.end_reason!r}')
        return result, wall

    out_dev = os.path.join(tmp, 'out_native_dev')
    reset_counts()
    analyzer, wall = analyze(out_dev, True)
    counts = read_counts()
    print(f'analyze(resample_on_device=True) on {len(names)} native-rate '
          f'WAVs ({", ".join(f"{r} Hz {c} ch" for r, c in NATIVE_RECORDINGS)}'
          f', {seconds:g} s each): end reason '
          f'{analyzer.coordinator.end_reason!r}, {wall:.2f} s wall, '
          f'{audio_s / wall:.1f} audio s per wall s, kernel launches '
          f'{counts}', flush=True)
    for name in ('fused_front', 'fused_tail'):
        if counts[name] <= 0:
            fail(f'the native-rate path never launched {name}')
    for name, rate in names.items():
        check_csvs(out_dev, [name], seconds, analyzer.chunklength, cfg,
                   rate=rate)
        check_chunk_on_cpu(analyzer, arrays,
                           os.path.join(dir_audio, f'{name}.wav'),
                           os.path.join(out_dev, f'{name}_buzzdetect.csv'),
                           'highest', input_rate=rate)
    # the same run again under the stack sampler: where the host's time
    # goes on this path (the run above is the one timed)
    with profile_pipeline.Sampler() as sampler:
        analyze(os.path.join(tmp, 'out_native_sampled'), True)
    print('sampled analyze(resample_on_device=True): quantize {:.1f}%, '
          'audio reads {:.1f}% of all stack samples\n'.format(
              *sampler_shares(sampler))
          + '\n'.join(profile_pipeline.report(sampler, 12)), flush=True)
    ok, why = native
    if not ok:
        print(f'native stage absent, so host resampling of these files, '
              f'the FLAC, decode_rate_probe and the sampled native-stage '
              f'analyze() did not run: {why.splitlines()[0]}', flush=True)
        return
    from buzzdetect_torch.audio.ffi import encode_fixture
    from buzzdetect_torch.tools import decode_rate_probe
    out_host = os.path.join(tmp, 'out_native_host')
    with profile_pipeline.Sampler() as sampler:
        result, wall = analyze(out_host, False)
    quant, reads = sampler_shares(sampler)
    print(f'analyze() with host resampling (the native stage) on the same '
          f'files: {wall:.2f} s wall, {audio_s / wall:.1f} audio s per wall '
          f's; sampler: quantize {quant:.1f}%, audio reads {reads:.1f}% of '
          f'all stack samples\n'
          + '\n'.join(profile_pipeline.report(sampler, 12)), flush=True)
    for name in names:
        check_csvs(out_host, [name], seconds, result.chunklength, cfg)
    flac_dir = os.path.join(tmp, 'flac_audio')
    os.makedirs(flac_dir)
    encode_fixture(os.path.join(flac_dir, 'fixture.flac'), 'flac', 48000, 1,
                   FLAC_SECONDS)
    out_flac = os.path.join(tmp, 'out_flac')
    result, wall = analyze(out_flac, True, where=flac_dir)
    check_csvs(out_flac, ['fixture'], FLAC_SECONDS, result.chunklength, cfg,
               rate=48000)
    for row in decode_rate_probe.probe(
            [f for f in decode_rate_probe.FAMILIES if f[0] in PROBE_CODECS],
            seconds=PROBE_SECONDS, trials=1):
        print(f'decode_rate_probe: {json.dumps(row)}', flush=True)


def xla_conv_phase(torch, dev, arrays, cfg, wire, path_audio, chunk_s,
                   kernel_classify_ms, reset_counts, read_counts, time_ms,
                   device_ms):
    """(a) The XLA conv path (``conv='xla'``) on the card at full width, in
    each of XLA_MODES: one chunk of ``path_audio`` on the card against the
    same chunk on the CPU; the hand conv kernels' launch counts over that
    call (set to 0 just before, read just after), which must all be 0; then,
    on the B=209 ``wire`` of phase 2, the conv stack's CUDA-event and device
    time (``torch.profiler``) beside the hand kernels' (layer 1 +
    fused_front + fused_tail) in the same mode, and the whole classify
    beside the kernel path's. Returns {mode: row}."""
    from buzzdetect_torch.audio import build_track
    from buzzdetect_torch.models import yamnet
    from buzzdetect_torch.models.classifier import (
        ChunkClassifier, _classify, _to_float)
    from buzzdetect_torch.ops import frontend, sepconv
    track = build_track(path_audio, target_rate=16000)
    samples = track.read_s16(int(chunk_s * 16000))
    track.close()
    rows = {}
    with torch.inference_mode():
        patches = frontend.log_mel_patches(_to_float(wire), cfg)
        b = patches.shape[0]
        for mode, kw in XLA_MODES.items():
            card = ChunkClassifier(arrays, device=dev, conv='xla',
                                   transfer_dtype='int16', **kw)
            if (card.conv, card.conv_precision) != ('xla', 'high'):
                fail(f'[xla {mode}] resolved to conv={card.conv!r}, '
                     f'conv_precision={card.conv_precision!r}')
            reset_counts()
            got = card.predict(samples)
            counts = read_counts()
            cpu = ChunkClassifier(arrays, device='cpu', conv='xla',
                                  transfer_dtype='int16', **kw
                                  ).predict(samples)
            d = float(np.abs(got - cpu).max())
            print(f'[xla {mode}] one {chunk_s:g} s chunk ({got.shape[0]} '
                  f'patches), card vs CPU: max |dscore| = {d:.3g} (budget '
                  f'{SCORE_ATOL[mode]}); hand kernel launches {counts}',
                  flush=True)
            if got.shape != cpu.shape or d > SCORE_ATOL[mode]:
                fail(f'[xla {mode}] card and CPU scores differ by {d:.3g}')
            if any(counts.values()):
                fail(f'[xla {mode}] launched hand kernels: {counts}')
            dtype = card.compute_dtype
            xla_params = card.params
            kernel_params = dict(xla_params, yamnet=sepconv.pack_params(
                xla_params['yamnet'], card.mode))
            stack = {
                'xla': lambda: yamnet.embed_xla(xla_params['yamnet'],
                                                patches, dtype, 'high'),
                'kernels': lambda: yamnet.embed(kernel_params['yamnet'],
                                                patches, dtype, 'highest')}
            classify = {
                'xla': lambda: _classify(xla_params, wire, cfg, 'xla', dtype,
                                         'high', conv='xla'),
                'kernels': lambda: _classify(kernel_params, wire, cfg, 'xla',
                                             dtype, 'highest')}
            row = {}
            for what, table in (('stack', stack), ('classify', classify)):
                for k, fn in table.items():
                    row[f'{k}_{what}'] = time_ms(fn)
                    row[f'{k}_{what}_device'] = device_ms(fn)
            emb = stack['xla']() - stack['kernels']()
            row['xla_vs_kernels_emb'] = float(emb.abs().max())
            row['ratio'] = (row['xla_stack_device']
                            / row['kernels_stack_device'])
            rows[mode] = row
            print(f'[xla {mode}] B={b}: conv stack (27 cuDNN convs + pool) '
                  f'{row["xla_stack"]:.4f} ms, device '
                  f'{row["xla_stack_device"]:.4f} ms; hand kernels (layer 1 '
                  f'+ fused_front + fused_tail) {row["kernels_stack"]:.4f} '
                  f'ms, device {row["kernels_stack_device"]:.4f} ms (xla / '
                  f'kernels {row["ratio"]:.2f}x by device time); whole '
                  f'classify {row["xla_classify"]:.4f} ms (device '
                  f'{row["xla_classify_device"]:.4f}) against the kernel '
                  f'path\'s {row["kernels_classify"]:.4f} ms (device '
                  f'{row["kernels_classify_device"]:.4f}; phase 2 read '
                  f'{kernel_classify_ms:.4f} ms in f32); max |xla - kernels| '
                  f'over the embeddings {row["xla_vs_kernels_emb"]:.3g}',
                  flush=True)
    ratio = rows['bf16']['xla_stack_device'] / rows['high']['xla_stack_device']
    print(f'[xla] bf16 / f32 device time of the conv stack: {ratio:.2f}x',
          flush=True)
    return rows


def xla_cli_phase(tmp, arrays, cfg, cli_audio, cli_names, cli_seconds,
                  reset_counts, read_counts, device='cuda'):
    """(b) The CLI (``cli.main``, in process) on the XLA_BUNDLE, whose
    config says ``"conv": "xla"``, and on model_general_v3 (the kernel
    path), on phase 3's CLI recordings: end reasons, the XLA run's realtime
    factor and hand-kernel launches (which must be 0), complete CSVs, one
    chunk on the card against the CPU, and every score of the two runs'
    CSVs equal after their 2-digit rounding (one unit of the last digit:
    a value within f32 rounding of a rounding edge may print the other
    way)."""
    from buzzdetect_torch import cli
    runs = {}
    for name in (MODEL, XLA_BUNDLE[0]):
        out = os.path.join(tmp, f'out_cli_{name}')
        reset_counts()
        t0 = time.perf_counter()
        result = cli.main(['--modelname', name, '--dir_audio', cli_audio,
                           '--dir_out', out, '--verbosity_print', 'WARNING',
                           '--device', device])
        wall = time.perf_counter() - t0
        counts = read_counts()
        reason = result.coordinator.end_reason
        audio_s = result.coordinator.audio_seconds_done
        print(f'CLI --modelname {name}: end reason {reason!r}, {wall:.2f} s '
              f'wall, {audio_s / wall:.1f} audio s per wall s, kernel '
              f'launches {counts}', flush=True)
        if reason != 'completed':
            fail(f'the CLI run of {name} ended {reason!r}')
        check_csvs(out, cli_names, cli_seconds, result.chunklength, cfg)
        runs[name] = (result, out, counts)
    result, out, counts = runs[XLA_BUNDLE[0]]
    if result.model.classifier.conv != 'xla' or any(counts.values()):
        fail(f'the "conv": "xla" bundle ran conv='
             f'{result.model.classifier.conv!r} with launches {counts}')
    check_chunk_on_cpu(result, arrays, os.path.join(cli_audio, 'site0.wav'),
                       os.path.join(out, 'site0_buzzdetect.csv'), 'high',
                       conv='xla')
    worst = 0.0
    for n in cli_names:
        tables = []
        for _result, d, _c in runs.values():
            with open(os.path.join(d, f'{n}_buzzdetect.csv')) as f:
                tables.append(np.array([ln.split(',') for ln in
                                        f.read().splitlines()[1:]], float))
        worst = max(worst, float(np.abs(tables[0] - tables[1]).max()))
    print(f'CSVs of "conv": "xla" against the kernel path: max |d| = '
          f'{worst:.3g} after 2-digit rounding (one unit of the last digit '
          f'allowed)', flush=True)
    if worst > 0.0101:
        fail(f'the XLA conv path\'s CSVs differ from the kernel path\'s by '
             f'{worst:.3g}')


def same_csvs(got_dir, want_dir, names, what):
    """Every recording's CSV in ``got_dir`` is byte-identical to its CSV in
    ``want_dir``."""
    for n in names:
        paths = [os.path.join(d, f'{n}_buzzdetect.csv')
                 for d in (got_dir, want_dir)]
        if not os.path.exists(paths[0]):
            fail(f'{what}: no complete CSV for {n}')
        with open(paths[0], 'rb') as a, open(paths[1], 'rb') as b:
            if a.read() != b.read():
                fail(f'{what}: {n}_buzzdetect.csv differs from the '
                     f'one-device, one-host run\'s')
    print(f'{what}: {len(names)} CSVs byte-identical to the one-device, '
          f'one-host run', flush=True)


def replica_phase(tmp, dir_audio, dir_out, names, reset_counts, read_counts,
                  devices=None):
    """(c) analyze(devices=REPLICA_DEVICES) on phase 3's recordings: two
    replicas, each with its own dispatch thread and CUDA stream; CSVs
    byte-identical to phase 3's one-device run in ``dir_out``; its realtime
    factor and launch counts."""
    import buzzdetect_torch
    devices = REPLICA_DEVICES if devices is None else devices
    out = os.path.join(tmp, 'out_replicas')
    reset_counts()
    t0 = time.perf_counter()
    result = buzzdetect_torch.analyze(
        modelname=MODEL, dir_audio=dir_audio, dir_out=out,
        verbosity_print='WARNING', devices=devices)
    wall = time.perf_counter() - t0
    counts = read_counts()
    reason = result.coordinator.end_reason
    audio_s = result.coordinator.audio_seconds_done
    print(f'analyze(devices={devices}): end reason {reason!r}, '
          f'{result.coordinator.analyzers_total} dispatch threads over '
          f'{len({id(m) for m in result.replica_models})} replicas, '
          f'{wall:.2f} s wall, {audio_s / wall:.1f} audio s per wall s, '
          f'kernel launches {counts}', flush=True)
    if reason != 'completed':
        fail(f'analyze(devices={devices}) ended {reason!r}')
    if len({id(m) for m in result.replica_models}) != len(devices):
        fail('the replicas share a model')
    if counts['fused_front'] <= 0 or counts['fused_tail'] <= 0:
        fail('the replicas never launched the conv kernels')
    same_csvs(out, dir_out, names, f'analyze(devices={devices})')


def host_shard_phase(tmp, dir_audio, dir_out, names, device='cuda'):
    """(d) Two concurrent ``python -m buzzdetect_torch --host_shard I/2``
    processes on one shared output folder: each exits 0, and the union of
    their CSVs is byte-identical to phase 3's one-host run in ``dir_out``.
    Every process started here is stopped before this returns."""
    from buzzdetect_torch.parallel import shard_files
    shared = os.path.join(tmp, 'out_host_shard')
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'buzzdetect_torch', '--modelname', MODEL,
         '--dir_audio', dir_audio, '--dir_out', shared, '--verbosity_print',
         'WARNING', '--device', device, '--host_shard', f'{i}/2'],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for i in range(2)]
    try:
        outs = [p.communicate(timeout=HOST_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    files = sorted(f'{n}.wav' for n in names)
    for i, (p, (_out, err)) in enumerate(zip(procs, outs)):
        print(f'host {i}/2: exit {p.returncode}, took '
              f'{shard_files(files, i, 2)}', flush=True)
        if p.returncode != 0:
            fail(f'host {i}/2 exited {p.returncode}: '
                 f'{err.decode()[-2000:]}')
    print(f'host_shard: two concurrent processes in {wall:.2f} s wall '
          f'(process start, kernel load and analysis)', flush=True)
    same_csvs(shared, dir_out, names, 'host_shard 0/2 + 1/2')


def write_corpus(root, seed=0):
    """Phase 7's corpus under ``root``: CORPUS_FILES recordings named as
    AudioMoth-style stations (``HIVE<i>_20240601_<hh>0000.wav``, one hour
    apart) of noise with CORPUS_EVENTS harmonic tone bursts each, and the
    annotation CSV (``ident,start,end,label``): every burst ``ins_buzz``,
    and as many noise-only stretches ``ambient_noise``. Returns (the audio
    directory, the CSV's path, the idents)."""
    rng = np.random.default_rng(seed)
    audio = os.path.join(root, 'corpus')
    os.makedirs(audio)
    rate = 16000
    t = np.arange(int(CORPUS_SECONDS * rate)) / rate
    rows, idents = ['ident,start,end,label'], []
    for i in range(CORPUS_FILES):
        ident = f'HIVE{i}_20240601_{10 + i:02d}0000'
        x = rng.standard_normal(len(t)) * 0.02
        slots = rng.permutation(int(CORPUS_SECONDS // 6))[:2 * CORPUS_EVENTS]
        for j, slot in enumerate(sorted(slots)):
            start = slot * 6.0 + rng.uniform(0, 2)
            end = start + rng.uniform(1.5, 3.5)
            if j % 2:
                rows.append(f'{ident},{start:.3f},{end:.3f},ambient_noise')
                continue
            sel = (t >= start) & (t < end)
            f0 = rng.uniform(180, 260)
            x[sel] += sum(0.2 / k * np.sin(2 * np.pi * f0 * k * t[sel])
                          for k in (1, 2, 3))
            rows.append(f'{ident},{start:.3f},{end:.3f},ins_buzz')
        ints = np.clip(np.round(x * 32768), -32768, 32767).astype('<i2')
        with wave.open(os.path.join(audio, f'{ident}.wav'), 'wb') as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(rate)
            w.writeframes(ints.tobytes())
        idents.append(ident)
    path_ann = os.path.join(root, 'events.csv')
    with open(path_ann, 'w') as f:
        f.write('\n'.join(rows) + '\n')
    return audio, path_ann, idents


def train_step_flops(b):
    """Operations of one full train step on b patches: every conv's
    multiply-adds counted twice, forward once and backward twice (the
    input's and the weight's gradients); BatchNorm, the frontend and the
    head are left out (under 1% of it)."""
    from buzzdetect_torch.models import yamnet
    h, w, flops = 96, 64, 0
    for _key, kind, stride, shape in yamnet._conv_shapes():
        h, w = -(-h // stride), -(-w // stride)
        fan = shape[0] * shape[1] * (1 if kind == 'depthwise' else shape[2])
        flops += 2 * h * w * fan * shape[3]
    return 3 * flops * b


def embed_train_f64(raw, patches, masks=None):
    """``yamnet.embed_train`` written out in float64 with plain
    ``F.conv2d`` on (B, 96, 64) patches: the referee for the f32 gradients
    of the card and the CPU. With ``masks`` (one per layer, from
    ``ReluBranches``) each ReLU takes the recorded branch. Returns (the
    embeddings, every layer's pre-activation)."""
    import torch
    import torch.nn.functional as F
    from buzzdetect_torch.models import yamnet
    from buzzdetect_torch.ops.sepconv import same_pad
    x, zs = patches[:, None], []
    for i, (key, kind, stride, _shape) in enumerate(yamnet._conv_shapes()):
        k = raw[f'{key}/kernel'].permute(3, 2, 0, 1)
        ph = same_pad(x.shape[2], stride, k.shape[-1])
        pw = same_pad(x.shape[3], stride, k.shape[-1])
        x = F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), k,
                     stride=stride,
                     groups=x.shape[1] if kind == 'depthwise' else 1)
        mean = x.mean(dim=(0, 2, 3))[:, None, None]
        var = x.var(dim=(0, 2, 3), correction=0)[:, None, None]
        z = (x - mean) / torch.sqrt(var + yamnet.BN_EPSILON) \
            + raw[f'{key}/bn_beta'][:, None, None]
        zs.append(z.detach().numpy())
        x = torch.relu(z) if masks is None else z * masks[i].double()
    return x.mean(dim=(2, 3)), zs


def relu_branches():
    """A ``TorchFunctionMode`` that records the branch (output > 0, on the
    CPU) of every ``torch.relu`` run inside it, in ``.masks``."""
    import torch
    from torch.overrides import TorchFunctionMode

    class ReluBranches(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.masks = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is torch.relu:
                self.masks.append((out > 0).detach().cpu())
            return out

    return ReluBranches()


def first_step_f64(state, patches, labels, masks=None):
    """The first step's float64 gradients from ``state`` (``{path:
    grad}``, the paths of ``trainer.trainable_leaves``) and pre-activations,
    along ``masks`` if given."""
    import torch
    from buzzdetect_torch.train import trainer
    p64 = {g: {k: torch.from_numpy(v.astype(np.float64)).requires_grad_()
               for k, v in leaves.items()} for g, leaves in state.items()}
    emb, zs = embed_train_f64(p64['yamnet_raw'], patches, masks)
    trainer.bce_with_logits_loss(
        emb @ p64['head']['head/kernel'] + p64['head']['head/bias'],
        labels).backward()
    return {f'{g}.{k}': t.grad.numpy() for g, leaves in p64.items()
            for k, t in leaves.items() if t.grad is not None}, zs


def head_phase(tmp, audio, ann, idents, reset_counts, read_counts,
               device='cuda'):
    """(a) ``buzzdetect_torch.tools.train_model`` head-only (HEAD_EPOCHS
    epochs) on the corpus: the conv kernels' launches over it (all of them
    in the embedding stage: one ``fused_front`` and one ``fused_tail`` per
    chunk embedded), one file's embeddings on the card against the same
    file on the CPU port, and the bundle's metrics table. Returns the
    bundle's name."""
    from buzzdetect_torch import config as cfg_mod
    from buzzdetect_torch.models.registry import load_model
    from buzzdetect_torch.tools import train_model
    from buzzdetect_torch.train.embed_corpus import embed_file
    from buzzdetect_torch.write.coverage import gaps_to_chunklist
    name, work = 'trained_head', os.path.join(tmp, 'work_head')
    reset_counts()
    t0 = time.perf_counter()
    train_model.main(['--name', name, '--dir-audio', audio, '--annotations',
                      ann, '--classes', *TRAIN_CLASSES, '--epochs',
                      str(HEAD_EPOCHS), '--dir-work', work, '--no-report',
                      '--device', device])
    wall = time.perf_counter() - t0
    counts = read_counts()
    chunk = max(round(200.0 / 0.96) * 0.96, 0.96)
    want = CORPUS_FILES * len(gaps_to_chunklist([(0.0, CORPUS_SECONDS)],
                                                chunk))
    print(f'(a) train_model head-only: {wall:.2f} s wall; kernel launches '
          f'{counts}, {want} predicted for the embedding stage '
          f'({CORPUS_FILES} files x one {chunk:.2f} s chunk each)',
          flush=True)
    others = {k: v for k, v in counts.items()
              if k not in ('fused_front', 'fused_tail') and v}
    if counts['fused_front'] != want or counts['fused_tail'] != want \
            or others:
        fail(f'the embedding stage launched {counts}, not {want} '
             f'fused_front and fused_tail')
    with np.load(os.path.join(work, f'{idents[0]}_embeddings.npz')) as z:
        starts, card = z['starts'], z['embeddings']
    cpu_model = load_model(MODEL, initialize=True, device='cpu')
    s_cpu, cpu = embed_file(cpu_model.classifier,
                            os.path.join(audio, f'{idents[0]}.wav'))
    d = float(np.abs(card - cpu).max())
    tol = EMB_RTOL * float(np.abs(cpu).max())
    print(f'(a) {idents[0]}: {card.shape} embeddings, card vs CPU max '
          f'|d| = {d:.3g} (tolerance {tol:.3g}: {EMB_RTOL} of the largest '
          f'|embedding|)', flush=True)
    if card.shape != cpu.shape or not np.array_equal(starts, s_cpu) \
            or d > tol:
        fail(f'card and CPU embeddings differ by {d:.3g}')
    with np.load(os.path.join(cfg_mod.resolve_dir(cfg_mod.DIR_MODELS),
                              name, 'model.npz')) as z:
        table = {k[len('metrics_'):]: z[k] for k in z.files
                 if k.startswith('metrics_')}
    if not table:
        fail('the head-only bundle has no metrics table')
    n = len(table['threshold'])
    rows = sorted({int(i) for i in np.linspace(0, n - 1, min(n, 6))})
    print(f'(a) metrics table: {n} rows; threshold, precision, '
          f'sensitivity, fpr of rows {rows}:', flush=True)
    for i in rows:
        print('      ' + ', '.join(f'{table[k][i]:.4g}' for k in
                                   ('threshold', 'precision', 'sensitivity',
                                    'fpr')), flush=True)
    return name


def full_phase(tmp, audio, ann, time_ms, device_ms, f32_peak, reset_counts,
               read_counts, device='cuda'):
    """(b) ``train_model --full`` (batch FULL_BATCH of 0.975 s clips,
    FULL_EPOCHS epochs); one train step's CUDA-event median and device
    time beside its bound from its operations; the first step's loss and
    per-leaf gradients against the CPU port from the same state; the
    resume test (the tool's run against FULL_EPOCHS - 1 epochs, then a
    resume to FULL_EPOCHS, bit for bit); one augmented step's loss.
    Returns the bundle's name."""
    import torch
    from buzzdetect_torch import config as cfg_mod
    from buzzdetect_torch.models import yamnet
    from buzzdetect_torch.models.heads import init_head
    from buzzdetect_torch.models.weights import train_state_from_numpy
    from buzzdetect_torch.ops.frontend import FrontendConfig, log_mel_patches
    from buzzdetect_torch.tools import train_model
    from buzzdetect_torch.train import trainer
    from buzzdetect_torch.train.annotations import load_events
    from buzzdetect_torch.train.clips import (build_clip_dataset,
                                              train_full_model)
    name, work = 'trained_full', os.path.join(tmp, 'work_full')
    reset_counts()
    t0 = time.perf_counter()
    train_model.main(['--name', name, '--dir-audio', audio, '--annotations',
                      ann, '--classes', *TRAIN_CLASSES, '--full', '--epochs',
                      str(FULL_EPOCHS), '--dir-work', work, '--no-report',
                      '--device', device])
    print(f'(b) train_model --full: {time.perf_counter() - t0:.2f} s wall; '
          f'kernel launches {read_counts()} (the fine-tune runs cuDNN '
          f'F.conv2d with autograd, no hand kernel)', flush=True)
    clips, labels = build_clip_dataset(audio, load_events(ann),
                                       TRAIN_CLASSES, log=lambda *_: None)
    print(f'(b) {len(clips)} clips of {clips.shape[1]} samples, '
          f'{int(labels.sum())} positive labels', flush=True)

    # the first step from the seeded state, card against CPU
    state = {'yamnet_raw': yamnet.init_raw_params(0),
             'head': init_head(yamnet.N_EMBEDDINGS, len(TRAIN_CLASSES))}
    w, y = clips[:FULL_BATCH], labels[:FULL_BATCH]
    steps = {}
    for dev in (device, 'cpu'):
        params, opt = train_state_from_numpy(state, learning_rate=1e-3,
                                             device=dev)
        branches = relu_branches()
        with trainer.training_flags():
            with branches:
                loss, _ = trainer.full_loss(
                    params, torch.from_numpy(w).to(dev),
                    torch.from_numpy(y).to(dev), FrontendConfig())
            loss.backward()
        grads = {p: t.grad.cpu().numpy()
                 for p, t in trainer.trainable_leaves(params)}
        steps[dev] = (float(loss.detach()), grads, branches.masks)
    patches = log_mel_patches(torch.from_numpy(w), FrontendConfig()).reshape(
        len(w), 96, 64).double()
    y64 = torch.from_numpy(y).double()
    g64, z64 = first_step_f64(state, patches, y64)
    (card_loss, card_g, card_m), (cpu_loss, cpu_g, cpu_m) = (
        steps[device], steps['cpu'])

    def shares(a, b, scale):
        return {p: float(np.abs(a[p] - b[p]).max())
                / float(np.abs(scale[p]).max()) for p in scale}

    def off_branches(masks):
        off = [(z > 0) != m.numpy() for z, m in zip(z64, masks)]
        return (int(sum(o.sum() for o in off)),
                max(float(np.abs(z[o]).max(initial=0.0))
                    for z, o in zip(z64, off)))

    rows = {'card - CPU': shares(card_g, cpu_g, g64),
            'card - float64': shares(card_g, g64, g64),
            'CPU - float64': shares(cpu_g, g64, g64)}
    for role, grads, masks in (('card', card_g, card_m),
                               ('CPU', cpu_g, cpu_m)):
        same, _z = first_step_f64(state, patches, y64, masks)
        rows[f'{role} - float64 on its branches'] = shares(grads, same,
                                                           same)
        rows[f'{role} branches off float64\'s'] = off_branches(masks)
    print(f'(b) first step at B={len(w)}: loss card {card_loss:.7g}, CPU '
          f'{cpu_loss:.7g}; per-leaf gradient max |d| / max |g64|, largest '
          f'(leaf) and median over {len(g64)} leaves:', flush=True)
    for k, v in rows.items():
        if isinstance(v, tuple):
            print(f'      {k}: {v[0]}, all at |z| <= {v[1]:.3g} (bound '
                  f'{BRANCH_EDGE})', flush=True)
            continue
        top = max(v, key=v.get)
        print(f'      {k}: {v[top]:.3g} ({top}), median '
              f'{float(np.median(list(v.values()))):.3g}', flush=True)
    bad = {role: [p for p, e in rows[f'{role} - float64 on its '
                                     f'branches'].items() if e > GRAD_RTOL]
           for role in ('card', 'CPU')}
    if abs(card_loss - cpu_loss) > 1e-5 * abs(cpu_loss) or any(
            bad.values()) or any(
            rows[f'{role} branches off float64\'s'][1] > BRANCH_EDGE
            for role in ('card', 'CPU')):
        fail(f'the first step\'s gradients are not float64\'s on their own '
             f'ReLU branches within {GRAD_RTOL} of each leaf\'s max |g| '
             f'(leaves {bad}), or a branch is taken off 0')

    # one step's time
    params, opt = train_state_from_numpy(state, learning_rate=1e-3,
                                         device=device)
    step = trainer.make_full_train_step(opt, params)
    wd, yd = torch.from_numpy(w).to(device), torch.from_numpy(y).to(device)
    ms, dev_ms = time_ms(lambda: step(wd, yd)), device_ms(
        lambda: step(wd, yd))
    flops = train_step_flops(len(w))
    bound_ms = 1e3 * flops / f32_peak
    print(f'(b) one train step, B={len(w)} clips: {ms:.4f} ms (CUDA events, '
          f'median), device {dev_ms:.4f} ms; bound {bound_ms:.4f} ms '
          f'(operations: {flops / 1e9:.2f} GFLOP at f32 peak; device / '
          f'bound {dev_ms / bound_ms:.1f}x)', flush=True)

    # resume: the tool's uninterrupted run against one epoch, then a resume
    resumed_dir = os.path.join(tmp, 'work_resume')
    kw = dict(learning_rate=1e-3, checkpoint_dir=resumed_dir,
              log=lambda *_: None, device=device)
    train_full_model(clips, labels, epochs=FULL_EPOCHS - 1, **kw)
    raw, head, _losses = train_full_model(clips, labels, epochs=FULL_EPOCHS,
                                          **kw)
    with np.load(os.path.join(cfg_mod.resolve_dir(cfg_mod.DIR_MODELS), name,
                              'model.npz')) as z:
        same = all(np.array_equal(z[f'yamnet_raw/{k}'], v)
                   for k, v in raw.items()) and all(
            np.array_equal(z[k], v) for k, v in head.items())
    print(f'(b) resume: {FULL_EPOCHS - 1} epoch, then a resume to '
          f'{FULL_EPOCHS}, against {FULL_EPOCHS} straight: '
          f'{"bit-identical" if same else "DIFFERENT"} over '
          f'{len(raw) + len(head)} arrays', flush=True)
    if not same:
        fail('the resumed fine-tune differs from the uninterrupted one')

    # one augmented step
    params, opt = train_state_from_numpy(state, learning_rate=1e-3,
                                         device=device)
    loss = float(trainer.make_full_train_step(opt, params, augment=True)(
        wd, yd, np.random.default_rng((0, 0))))
    print(f'(b) one --augment step: loss {loss:.7g}', flush=True)
    if not np.isfinite(loss):
        fail('the augmented step\'s loss is not finite')
    return name


def run_writers(dir_results, dir_writers, thr, dir_audio):
    """``call_detections`` (events CSV, Audacity, Raven, event clips at
    threshold ``thr``), ``activity_report`` and ``trim_results`` on the
    CSVs in ``dir_results`` (which trimming adds its archives to), their
    outputs under ``dir_writers``."""
    from buzzdetect_torch.tools import (activity_report, call_detections,
                                        trim_results)
    os.makedirs(dir_writers)
    calib = ['--dir_results', dir_results, '--threshold', f'{thr:.6f}']
    call_detections.main(calib + ['--out',
                                  os.path.join(dir_writers, 'events.csv')])
    for fmt in ('audacity', 'raven'):
        call_detections.main(calib + ['--format', fmt, '--out',
                                      os.path.join(dir_writers, fmt)])
    call_detections.main(calib + ['--format', 'clips', '--out',
                                  os.path.join(dir_writers, 'clips'),
                                  '--dir_audio', dir_audio])
    activity_report.main(calib + ['--out',
                                  os.path.join(dir_writers, 'activity.csv')])
    trim_results.main(['--dir_results', dir_results])


def writer_outputs(dir_results, dir_writers):
    """{relative path: bytes} of ``run_writers``' outputs, the trimmed
    archives under ``trim/``."""
    out = _tree_bytes(dir_writers)
    out.update({f'trim/{k}': v for k, v in _tree_bytes(dir_results).items()
                if k.endswith('.npz')})
    return out


def writers_phase(tmp, audio, ident, bundles, reset_counts, read_counts,
                  device='cuda'):
    """(c) analyze() with each trained bundle on one recording, on the card
    and on the CPU port; then ``run_writers`` on each run's CSVs, once in
    this process and once in a process that sees no card. The card's
    CSVs and the CPU's may differ only by one unit of their last digit (a
    score within f32 rounding of a rounding edge; the cells are printed).
    Each CSV's writer outputs must be byte-identical between the two
    processes (a trimmed archive member by member), and, where the card's
    CSVs equal the CPU's, between the card's run and the CPU's."""
    import buzzdetect_torch
    one = os.path.join(tmp, 'one_recording')
    os.makedirs(one)
    os.symlink(os.path.join(audio, f'{ident}.wav'),
               os.path.join(one, f'{ident}.wav'))
    jobs, checks = [], []
    for name in bundles:
        runs = {}
        for role, dev in (('card', device), ('cpu', 'cpu')):
            out = os.path.join(tmp, f'res_{name}_{role}')
            reset_counts()
            result = buzzdetect_torch.analyze(
                modelname=name, dir_audio=one, dir_out=out,
                verbosity_print='WARNING', device=dev)
            counts = read_counts()
            with open(os.path.join(out, f'{ident}_buzzdetect.csv')) as f:
                rows = f.read().splitlines()
            print(f'(c) analyze({name}, device={dev!r}): end reason '
                  f'{result.coordinator.end_reason!r}, {len(rows) - 1} CSV '
                  f'rows, kernel launches {counts}', flush=True)
            if result.coordinator.end_reason != 'completed':
                fail(f'analyze of {name} on {dev} ended '
                     f'{result.coordinator.end_reason!r}')
            if role == 'card' and (counts['fused_front'] <= 0
                                   or counts['fused_tail'] <= 0):
                fail(f'analyze of {name} never launched the conv kernels')
            runs[role] = (out, np.array([r.split(',') for r in rows[1:]],
                                        float))
        card_t, cpu_t = runs['card'][1], runs['cpu'][1]
        d = np.abs(card_t - cpu_t)
        flips = [(int(i), int(j), float(card_t[i, j]), float(cpu_t[i, j]))
                 for i, j in np.argwhere(d > 0)]
        if d.max() > 0.0101:
            fail(f'{name}: card and CPU CSVs differ by {d.max():.3g}')
        # a threshold inside the card run's ins_buzz range, so events exist
        thr = float(np.quantile(card_t[:, 1], 0.8))
        dirs = {}
        for role, (out, _t) in runs.items():
            for where in ('here', 'nocard'):
                key = f'{name}_{role}_{where}'
                dirs[role, where] = (os.path.join(tmp, f'csv_{key}'),
                                     os.path.join(tmp, f'writers_{key}'))
                shutil.copytree(out, dirs[role, where][0])
            run_writers(*dirs[role, 'here'], thr, one)
            jobs.append((*dirs[role, 'nocard'], thr, one))
        checks.append((name, thr, flips, dirs))
    # the same writers in a process that sees no card
    code = (f'import sys; sys.path.insert(0, {ROOT!r}); import chip_smoke; '
            f'[chip_smoke.run_writers(*job) for job in {jobs!r}]')
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    proc = subprocess.run([sys.executable, '-c', code], env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode:
        fail(f'the writers without a card exited {proc.returncode}: '
             f'{proc.stderr[-2000:]}')
    for name, thr, flips, dirs in checks:
        got = {k: writer_outputs(*v) for k, v in dirs.items()}
        kinds = collections.Counter(k.split('/')[0] for k in
                                    got['cpu', 'here'])
        same_process = {role: got[role, 'here'] == got[role, 'nocard']
                        for role in ('card', 'cpu')}
        same_run = got['card', 'here'] == got['cpu', 'here']
        print(f'(c) {name}: threshold {thr:.4f}; writer outputs '
              f'{dict(sorted(kinds.items()))}; each CSV\'s outputs here '
              f'and in a process without a card: {same_process}; card\'s '
              f'run vs CPU\'s: {"byte-identical" if same_run else "differ"};'
              f' CSV cells that differ (row, column, card, CPU): {flips}',
              flush=True)
        if not all(same_process.values()) or (not flips and not same_run):
            fail(f'{name}: the writers\' outputs differ on the same CSVs')


def _tree_bytes(root):
    """{relative path: bytes} under ``root``; an npz as its members'
    bytes (the zip container stamps the time of writing)."""
    import zipfile
    out = {}
    for base, _dirs, files in os.walk(root):
        for f in files:
            path = os.path.join(base, f)
            rel = os.path.relpath(path, root)
            if f.endswith('.npz'):
                with zipfile.ZipFile(path) as z:
                    out[rel] = [z.read(n) for n in sorted(z.namelist())]
            else:
                with open(path, 'rb') as fh:
                    out[rel] = fh.read()
    return out


def training_phase(tmp, time_ms, device_ms, f32_peak, reset_counts,
                   read_counts, device='cuda'):
    """Phase 7: the corpus, then (a) head-only training, (b) the full
    fine-tune, (c) analysis with both bundles and the writers."""
    t0 = time.perf_counter()
    audio, ann, idents = write_corpus(tmp)
    print(f'7. training and writers: {CORPUS_FILES} x {CORPUS_SECONDS:g} s '
          f'corpus with {CORPUS_EVENTS} ins_buzz and {CORPUS_EVENTS} '
          f'ambient_noise events each', flush=True)
    bundles = [head_phase(tmp, audio, ann, idents, reset_counts, read_counts,
                          device),
               full_phase(tmp, audio, ann, time_ms, device_ms, f32_peak,
                          reset_counts, read_counts, device)]
    writers_phase(tmp, audio, idents[0], bundles, reset_counts, read_counts,
                  device)
    print(f'7. done in {time.perf_counter() - t0:.1f} s', flush=True)


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
    from buzzdetect_torch.ops import _build, frontend, logmel, probe, sepconv
    from buzzdetect_torch.tools import (capability_probe, profile_pipeline,
                                        roofline)
    from buzzdetect_torch.tools.roofline import (
        library_stack, library_weights, peaks)
    from buzzdetect_torch.utils import cuda_device_ms as device_ms
    from buzzdetect_torch.utils import cuda_time_ms as time_ms
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
    probe.load_kernels()
    print(f'built and loaded {", ".join(SOURCES.values())} in '
          f'{time.perf_counter() - t0:.1f} s (one nvcc per source, in '
          f'parallel)', flush=True)
    native = decoder_line()

    # --- 2. kernels against their plain versions -----------------------
    sepconv.exact_f32()
    dev = torch.device('cuda')
    with np.load(os.path.join(ROOT, 'models', MODEL, 'model.npz')) as z:
        arrays = {k: z[k] for k in z.files}
    all_params = params_from_numpy(arrays, dev)
    cfg = frontend.FrontendConfig().with_framehop(1.0)
    rows, outputs = {}, {}
    # CUDA events less device time, per call: the host's launch work
    host_ms = {}
    sms, clusters = logmel._card(dev, logmel.load_kernels())
    print(f'log_mel: cudaOccupancyMaxActiveClusters per (FT, CS): '
          f'{clusters} on {sms} SMs', flush=True)

    def check_row(name, b, got, ref, again, run_kernel, run_plain,
                  run_library, work, tol, product=None):
        """Hold one kernel call against its plain version, time the three,
        give the kernel's and the library call's device time alone, print
        the row; keep it at B=209. A conv row also gives the unit that runs
        its layers' product ('mma' or 'ffma')."""
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
        row = dict(max_abs_err=err, ms=time_ms(run_kernel),
                   plain_ms=time_ms(run_plain),
                   library_ms=time_ms(run_library),
                   device_ms=device_ms(run_kernel),
                   library_device_ms=device_ms(run_library),
                   **bound(t_ops, t_bytes))
        row['ratio'] = row['ms'] / row['library_ms']
        if product is not None:
            row['product'] = product
        torch.cuda.synchronize()
        print(f'kernel {name} B={b}: max |kernel - plain| = {err:.3g} '
              f'(atol {atol:.3g}, rtol {rtol:.3g}); kernel {row["ms"]:.4f} '
              f'ms, plain {row["plain_ms"]:.4f} ms, library '
              f'{row["library_ms"]:.4f} ms (kernel / library '
              f'{row["ratio"]:.2f}x), bound {row["bound_ms"]:.4f} ms '
              f'({row["bound_by"]}: {flops / 1e9:.2f} GFLOP, '
              f'{n_bytes / 1e6:.1f} MB)', flush=True)
        unit = ('' if product is None else
                f'every layer\'s product on {PRODUCT_UNITS[product]}; ')
        print(f'  {name} B={b}: {unit}device time (kernels only, '
              f'torch.profiler) kernel {row["device_ms"]:.4f} ms, library '
              f'{row["library_device_ms"]:.4f} ms (kernel / library '
              f'{row["device_ms"] / row["library_device_ms"]:.2f}x)',
              flush=True)
        if not ok:
            fail(f'{name} B={b} disagrees with its plain version: max |d| '
                 f'{err:.3g}')
        if name == 'log_mel':
            host_ms[f'log_mel B={b}'] = row['ms'] - row['device_ms']
            host_ms[f'matmul frontend B={b}'] = (
                row['library_ms'] - row['library_device_ms'])
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
            g = logmel.geometry_on(w.device, n_frames, 1)
            print(f'log_mel B={b} ({n_frames} frames) geometry: FT {g.ft} '
                  f'frames per cluster of {g.cs} blocks, {g.blocks} blocks of '
                  f'{g.threads} threads, grid {g.grid}; busiest SM '
                  f'{g.busiest} (frame, bin-chunk) pairs against a mean of '
                  f'{g.mean:.1f} ({g.busiest / g.mean:.3f}x); '
                  f'cudaOccupancyMaxActiveClusters {g.clusters}', flush=True)
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
                              bf16_scale if mode == 'bf16' else exact,
                              sepconv.layer_route(mode))

        # each mode's device time layer by layer, at B = 209, each layer on
        # its input from the plain stack, with its bound; in exact f32 also
        # the cuDNN layer's (TF32 off), to show where the FFMA kernel loses
        layer_ms = {}
        for mode in sepconv.MODES:
            params = sepconv.pack_params(all_params['yamnet'], mode)
            x = yamnet.layer1(params, patches, mode)
            parts, vs_library = [], []
            for s in sepconv.tail_specs(2, None):
                layer = dict(start_layer=s.index, stop_layer=s.index + 1,
                             gap=False, mode=mode)
                pw_f, dw_f, n_bytes = stack_work((s,), b0, False, mode)
                t_ops = ((pw_f + dw_f) / f32_peak if mode == 'highest'
                         else max(pw_f / bf16_peak, dw_f / f32_peak))
                t_bound = max(t_ops, n_bytes / bytes_peak)
                ms = device_ms(lambda: sepconv.fused_tail(params, x, **layer))
                layer_ms[mode, s.index] = ms
                parts.append(f'{s.index}: {ms:.4f} (bound {1e3 * t_bound:.4f}'
                             f', {ms / (1e3 * t_bound):.1f}x)')
                if mode == 'highest':
                    lib_w = library_weights(params, (s,), torch.float32)
                    x_nchw = x.permute(0, 3, 1, 2).contiguous()
                    lib_ms = device_ms(lambda: library_stack(
                        lib_w, x_nchw, (s,), False))
                    vs_library.append(f'{s.index}: {lib_ms:.4f} '
                                      f'({ms / lib_ms:.2f}x)')
                x = sepconv.fused_tail_plain(params, x, **layer).reshape(
                    b0, s.h_out, s.w_out, s.c_out)
            print(f'device time per layer, ms, [{mode}] B={b0}: '
                  + ', '.join(parts), flush=True)
            if vs_library:
                print(f'cuDNN f32 device time per layer, ms (FFMA kernel / '
                      f'cuDNN) B={b0}: ' + ', '.join(vs_library), flush=True)
        for mode in ('bf16', 'high'):
            ratios = (f'{i}: {layer_ms[mode, i] / layer_ms["highest", i]:.2f}x'
                      for i in range(2, 15))
            print(f'[{mode}] tensor cores / exact-f32 FFMA kernel, per layer: '
                  + ', '.join(ratios), flush=True)

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
        stage_ms = {k: time_ms(fn) for k, fn in stages.items()}
        classify_ms = time_ms(lambda: _classify(all_params, wire, cfg))
        pallas_ms = time_ms(lambda: _classify(all_params, wire, cfg,
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

    # --- 4. the developer tools ----------------------------------------
    # (a) the capability probe: its 23 cases through the kernels
    for kernel in probe.KERNELS:
        kernel.launches = 0
    results = capability_probe.run_probe(dev)
    counts = {k.__name__: k.launches for k in probe.KERNELS}
    bad = {n: s for n, s in results.items() if s != 'PASS'}
    print(f'capability probe: {len(results) - len(bad)} of {len(results)} '
          f'cases PASS on the card; kernel launches {counts}', flush=True)
    if bad or len(results) != 23:
        fail(f'capability probe cases not passing: {bad}')
    for name in ('remap',) + DOTS:
        if counts[name] <= 0:
            fail(f'the capability probe never launched {name}')
        launches[name] = counts[name]
    if counts['remap'] != 1:
        fail(f'the capability probe launched remap {counts["remap"]} times; '
             f'its 20 layout cases are one batch')

    with torch.inference_mode():
        # remap: the 20 layout cases on the probe's inputs, as one batch
        # (one launch), beside the per-case path (20 batches of one) and one
        # PyTorch call per case
        items = capability_probe.layout_items(dev)
        cases = [(name, [x] + ([w] if w is not None else []))
                 for name, x, w in items]

        def per_case():
            return [probe.remap(*item) for item in items]

        def plain():
            return [probe.remap_plain(*item) for item in items]
        got, again = probe.remap_batch(items), probe.remap_batch(items)
        single, ref = per_case(), plain()
        torch.cuda.synchronize()
        if not all(torch.equal(g, a) for g, a in zip(got, again)):
            fail('remap: two launches on the same input differ')
        if not all(torch.equal(g, o) for g, o in zip(got, single)):
            fail('remap: the batch differs from the per-case path')
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        n_bytes = sum(remap_bytes(torch, name, ts, g)
                      for (name, ts), g in zip(cases, got))
        n_mul = got[-1].numel()   # outer_broadcast_mul's multiplies
        library = remap_library(torch, cases)
        if not all(torch.equal(call(), r) for call, r in zip(library, ref)):
            fail('remap: a library call differs from the plain version')

        def run_library():
            return [call() for call in library]
        rows['remap'] = dict(
            max_abs_err=err, ms=time_ms(lambda: probe.remap_batch(items)),
            plain_ms=time_ms(plain), library_ms=time_ms(run_library),
            device_ms=device_ms(lambda: probe.remap_batch(items)),
            library_device_ms=device_ms(run_library),
            **bound(n_mul / f32_peak, n_bytes / bytes_peak))
        r = rows['remap']
        r['ratio'] = r['ms'] / r['library_ms']
        per_case_ms, per_case_device = time_ms(per_case), device_ms(per_case)
        print(f'kernel remap, 20 layout cases in one launch: max |kernel - '
              f'plain| = {err} (exact); kernel {r["ms"]:.4f} ms, plain '
              f'{r["plain_ms"]:.4f} ms, library {r["library_ms"]:.4f} ms (one '
              f'PyTorch call per case, each equal to the plain version; '
              f'kernel / library {r["ratio"]:.2f}x), bound '
              f'{r["bound_ms"]:.4f} ms ({r["bound_by"]}: {n_bytes / 1e6:.1f} '
              f'MB); device time (torch.profiler) kernel '
              f'{r["device_ms"]:.4f} ms, library '
              f'{r["library_device_ms"]:.4f} ms (kernel / library '
              f'{r["device_ms"] / r["library_device_ms"]:.2f}x)', flush=True)
        print(f'  remap per case (20 launches, each a batch of one, equal to '
              f'the batch): {per_case_ms:.4f} ms by CUDA events, device time '
              f'{per_case_device:.4f} ms', flush=True)
        if err != 0:
            fail(f'remap disagrees with its plain version by {err}')

        # (b) the three products at the probe's shape and the tail's own
        # pointwise shapes at B = 209: layer 8's input activations (layers
        # 8-12 run this product) and layer 14's, with those layers'
        # pointwise weights from the bundle
        params = all_params['yamnet']
        flat, w = capability_probe.dot_inputs()
        l14_in = sepconv.fused_tail_plain(params, mid, start_layer=8,
                                          stop_layer=14, gap=False)
        shapes = (
            ('probe', torch.from_numpy(flat).to(dev),
             torch.from_numpy(w).to(dev)),
            ('layers 8-12', mid.reshape(-1, 512).contiguous(),
             params['layer8/pointwise_conv/kernel']),
            ('layer 14', l14_in.reshape(-1, 1024).contiguous(),
             params['layer14/pointwise_conv/kernel']))
        for label, a, w in shapes:
            m, k = a.shape
            n = w.shape[1]
            library_ms = time_ms(lambda: torch.matmul(a, w))
            library_device = device_ms(lambda: torch.matmul(a, w))
            for name in DOTS:
                kern, plain = getattr(probe, name), getattr(probe,
                                                            f'{name}_plain')
                w_op = (sepconv.pack_pointwise(w, 'high')
                        if name == 'dot_high_emulated' else w)
                got, again = kern(a, w_op), kern(a, w_op)
                ref = plain(a, w_op)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    fail(f'{name} {label}: two launches differ')
                err = float((got - ref).abs().max())
                # HIGH: three products of bf16 operands, at the card's bf16
                # rate whichever unit the kernel runs them on (as the conv
                # kernels' HIGH rows)
                flops = 2 * m * n * k * (1 if name == 'dot_f32' else 3)
                t_ops = flops / (f32_peak if name == 'dot_f32'
                                 else bf16_peak)
                # the weight: f32, or its bf16 hi/lo pair (as many bytes)
                n_bytes = 4 * (m * k + m * n + k * n)
                row = dict(max_abs_err=err, ms=time_ms(lambda: kern(a, w_op)),
                           plain_ms=time_ms(lambda: plain(a, w_op)),
                           library_ms=library_ms,
                           **bound(t_ops, n_bytes / bytes_peak),
                           product=DOT_UNITS[name],
                           device_ms=device_ms(lambda: kern(a, w_op)),
                           library_device_ms=library_device)
                row['ratio'] = row['ms'] / library_ms
                print(f'kernel {name} {label} ({m}x{k} @ {k}x{n}) on '
                      f'{PRODUCT_UNITS[row["product"]]}: max '
                      f'|kernel - plain| = {err:.3g} (atol {ATOL}, rtol '
                      f'{RTOL}); kernel {row["ms"]:.4f} ms, plain '
                      f'{row["plain_ms"]:.4f} ms, torch.matmul f32 '
                      f'{library_ms:.4f} ms (kernel / library '
                      f'{row["ratio"]:.2f}x), bound {row["bound_ms"]:.4f} ms '
                      f'({row["bound_by"]}: {flops / 1e9:.2f} GFLOP, '
                      f'{n_bytes / 1e6:.1f} MB); device time (torch.profiler)'
                      f' kernel {row["device_ms"]:.4f} ms ('
                      f'{flops / row["device_ms"] / 1e9:.1f} TFLOP/s), '
                      f'torch.matmul '
                      f'{library_device:.4f} ms (kernel / library '
                      f'{row["device_ms"] / library_device:.2f}x)',
                      flush=True)
                if not torch.allclose(got, ref, atol=ATOL, rtol=RTOL):
                    fail(f'{name} {label} disagrees with its plain version: '
                         f'max |d| {err:.3g}')
                if label == 'layers 8-12':
                    rows[name] = row
                if label != 'probe':
                    host_ms[f'{name} {label}'] = (row['ms']
                                                  - row['device_ms'])
            if label != 'probe':
                host_ms[f'torch.matmul {label}'] = library_ms - library_device
        print('host launch work (CUDA events - device time), ms per call: '
              + ', '.join(f'{k} {v:.4f}' for k, v in host_ms.items()),
              flush=True)

        # the two HIGH routes against float64 of their common function
        # (a_hi w_hi + a_hi w_lo + a_lo w_hi), on seeded standard-normal
        # operands at the tail's two shapes: on the model's operands all
        # routes lie within 5e-6, too close to tell one bf16 pass from three
        gen = torch.Generator(device=dev).manual_seed(2)
        for m, k in ((5016, 512), (1254, 1024)):
            a = torch.randn((m, k), device=dev, generator=gen)
            w = torch.randn((k, k), device=dev, generator=gen)
            w_hilo = sepconv.pack_pointwise(w, 'high')
            a_hi = a.to(torch.bfloat16)
            a_lo = (a - a_hi.float()).to(torch.bfloat16).double()
            a_hi, w_hi, w_lo = (a_hi.double(), w_hilo[0].double(),
                                w_hilo[1].double())
            one_pass = a_hi @ w_hi
            exact = one_pass + a_hi @ w_lo + a_lo @ w_hi
            one_pass_err = float((one_pass - exact).abs().max())
            for name, out in (('dot_high', probe.dot_high(a, w)),
                              ('dot_high_emulated',
                               probe.dot_high_emulated(a, w_hilo)),
                              ('dot_high_plain', probe.dot_high_plain(a, w))):
                d = out.double() - exact
                err = float(d.abs().max())
                print(f'HIGH vs float64, standard-normal {m}x{k} @ {k}x{k}, '
                      f'{name}: max |d| {err:.3g} (bound {HIGH_F64_ATOL}; '
                      f'one bf16 pass {one_pass_err:.3g}), mean |d| '
                      f'{float(d.abs().mean()):.3g}, mean d '
                      f'{float(d.mean()):.3g} (max |value| '
                      f'{float(exact.abs().max()):.3g})', flush=True)
                if not err <= HIGH_F64_ATOL < one_pass_err:
                    fail(f'{name} {m}x{k}x{k}: max |d| {err:.3g} from float64 '
                         f'(bound {HIGH_F64_ATOL}, one bf16 pass '
                         f'{one_pass_err:.3g})')

    # (c) analyze(profile_dir=) on one short recording: a torch.profiler
    # trace that must name the conv kernels
    prof_audio = os.path.join(tmp, 'prof_audio')
    os.makedirs(prof_audio)
    write_recording(os.path.join(prof_audio, 'short.wav'), PROFILED_SECONDS,
                    5)
    # one run without the profiler, then one with it, for its cost; the
    # profiled run's trace and launch counts are checked
    walls = {}
    trace_dir = os.path.join(tmp, 'trace')
    for profiled in (False, True):
        reset_counts()
        t0 = time.perf_counter()
        result = buzzdetect_torch.analyze(
            modelname=MODEL, dir_audio=prof_audio,
            dir_out=os.path.join(tmp, f'out_prof{int(profiled)}'),
            verbosity_print='WARNING',
            profile_dir=trace_dir if profiled else None)
        walls[profiled] = time.perf_counter() - t0
        if result.coordinator.end_reason != 'completed':
            fail(f'analyze(profile_dir=) ({"with" if profiled else "without"}'
                 f' the profiler) ended {result.coordinator.end_reason!r}')
    counts = read_counts()
    traces = [os.path.join(b, f) for b, _d, files in os.walk(trace_dir)
              for f in files if f.endswith('.json')]
    if len(traces) != 1:
        fail(f'analyze(profile_dir=) wrote {traces}, expected one trace')
    with open(traces[0]) as f:
        events = [e for e in json.load(f)['traceEvents'] if e.get('ph') == 'X']
    device_ops = sorted((e for e in events if e.get('cat') in (
        'kernel', 'gpu_memcpy', 'gpu_memset')), key=lambda e: -e['dur'])
    conv = [e for e in device_ops if 'sep_layer_kernel' in e['name']]
    main_tid = threading.main_thread().native_id
    cpu_tids = collections.Counter(e['tid'] for e in events
                                   if e.get('cat') == 'cpu_op')
    print(f'analyze(profile_dir=) on {PROFILED_SECONDS:.0f} s: wall '
          f'{walls[True]:.3f} s profiled, {walls[False]:.3f} s without; '
          f'kernel launches {counts}; trace {os.path.basename(traces[0])} '
          f'({os.path.getsize(traces[0]) / 1e6:.1f} MB): {len(device_ops)} '
          f'device ops, {len(conv)} of them sep_layer_kernel; CPU ops by '
          f'thread: main {cpu_tids.pop(main_tid, 0)}, other threads '
          f'{dict(cpu_tids)}', flush=True)
    for e in device_ops[:5]:
        print(f'  {e["dur"]:10.1f} us  {e["cat"]:10s} {e["name"][:90]}',
              flush=True)
    if not conv or counts['fused_front'] <= 0:
        fail('the profiled run\'s trace names no sep_layer_kernel')

    # (d) the pipeline sampler around one analyze() of phase 3's recordings
    with profile_pipeline.Sampler() as sampler:
        t0 = time.perf_counter()
        result = buzzdetect_torch.analyze(
            modelname=MODEL, dir_audio=dir_audio,
            dir_out=os.path.join(tmp, 'out_sampled'),
            verbosity_print='WARNING')
        wall = time.perf_counter() - t0
    if result.coordinator.end_reason != 'completed':
        fail(f'the sampled analyze() ended {result.coordinator.end_reason!r}')
    print(f'sampled analyze(): {wall:.2f} s wall; '
          + '\n'.join(profile_pipeline.report(sampler, 12)), flush=True)
    print('sampled analyze(): quantize {:.1f}%, audio reads {:.1f}% of all '
          'stack samples'.format(*sampler_shares(sampler)), flush=True)

    # (e) the roofline of one 200 s chunk with peaks measured on the card
    probe.fma_chain.launches = 0
    roofline.main(['--seconds', '200.64', '--measure'])
    launches['fma_chain'] = probe.fma_chain.launches
    if launches['fma_chain'] <= 0:
        fail('the roofline never launched fma_chain')
    with torch.inference_mode():
        x = torch.randn(roofline.FMA_ELEMENTS, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
        args = (roofline.FMA_STEPS, roofline.FMA_A, roofline.FMA_B)
        got, again = probe.fma_chain(x, *args), probe.fma_chain(x, *args)
        ref = probe.fma_chain_plain(x, *args)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        flops = 2 * roofline.FMA_STEPS * x.numel()
        rows['fma_chain'] = dict(
            max_abs_err=err, ms=time_ms(lambda: probe.fma_chain(x, *args)),
            plain_ms=time_ms(lambda: probe.fma_chain_plain(x, *args)),
            library_ms=None,
            **bound(flops / f32_peak, 8 * x.numel() / bytes_peak))
        r = rows['fma_chain']
        print(f'kernel fma_chain ({x.numel()} x {roofline.FMA_STEPS} steps): '
              f'max |kernel - plain| = {err:.3g} (bound {FMA_RTOL} max(|x|, '
              f'1)); the chain moved values by up to '
              f'{float((ref - x).abs().max()):.3g}; kernel '
              f'{r["ms"]:.4f} ms ({flops / r["ms"] / 1e9:.1f} TFLOP/s), '
              f'plain {r["plain_ms"]:.4f} ms, bound {r["bound_ms"]:.4f} ms '
              f'({r["bound_by"]})', flush=True)
        if not torch.equal(got, again):
            fail('fma_chain: two launches differ')
        if not bool(((got - ref).abs()
                     <= FMA_RTOL * x.abs().clamp(min=1.0)).all()):
            fail(f'fma_chain disagrees with its plain version: {err:.3g}')

    # --- 5. native rates: on-device resampling and the decode stage ----
    resampler_phase(torch, dev, f32_peak, bytes_peak, time_ms, device_ms)
    native_rate_phase(tmp, arrays, cfg, native, reset_counts, read_counts)

    # --- 6. the XLA conv path and the layouts without a collective -----
    xla_conv_phase(torch, dev, arrays, cfg, wire,
                   os.path.join(dir_audio, 'rec0.wav'), analyzer.chunklength,
                   classify_ms, reset_counts, read_counts, time_ms, device_ms)
    xla_cli_phase(tmp, arrays, cfg, cli_audio, cli_names, cli_seconds,
                  reset_counts, read_counts)
    replica_phase(tmp, dir_audio, dir_out, names, reset_counts, read_counts)
    host_shard_phase(tmp, dir_audio, dir_out, names)

    # --- 7. training and writers ---------------------------------------
    training_phase(tmp, time_ms, device_ms, f32_peak, reset_counts,
                   read_counts)

    # --- 8. the kernels line ------------------------------------------
    print(f'torch.profiler sessions that recorded no device time on any '
          f'attempt, timed by CUDA events instead: {device_ms.fallbacks}',
          flush=True)
    order = ('fused_front', 'fused_tail', 'fused_front[bf16]',
             'fused_tail[bf16]', 'fused_front[high]', 'fused_tail[high]',
             'log_mel', 'remap') + DOTS + ('fma_chain',)
    table = []
    for name in order:
        r = rows[name]
        base = name.split('[')[0]
        source = SOURCES['logmel' if base == 'log_mel' else
                         'sepconv' if base.startswith('fused') else 'probe']
        table.append({'name': name, 'route': 'cuda', 'source': source,
                      'replaces': REPLACES[base],
                      'launches': launches[name],
                      'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
                      'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
                      'bound_by': r['bound_by'],
                      'library_ms': r['library_ms'],
                      **{k: r[k] for k in ('ratio', 'product', 'device_ms',
                                           'library_device_ms') if k in r}})
    print(json.dumps({'kernels': table}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
