#!/usr/bin/env python3
"""Smoke test of the PyTorch port (buzzdetect_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printed before the last line:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the build of the six CUDA libraries from ``buzzdetect_torch/csrc``
   (``sepconv``, ``logmel``, ``probe``, ``attention``, ``epilogue``,
   ``layer1``; one ``nvcc`` per source, started
   together); then the ``decoder:`` line: the FFmpeg libraries that
   ``pkg-config`` finds, or their absence, and ``audio.ffi.native_status()``
   (a native stage that fails to build where FFmpeg is present fails the
   run);
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (B = 209 patches, one default 200 s chunk; and B = 5), with
   the weights of ``models/model_general_v3/model.npz``: the conv kernels in
   their three modes (exact f32, bf16, emulated HIGH) and the fused log-mel
   (with the geometry each of its launches takes: frames a block, blocks,
   the busiest SM's frames, blocks an SM runs at once; its bound by
   ``benchmark/roofline.frontend_flops``' FFT count, and beside it by the
   dense-DFT count). Each row
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
   ratio of the bf16 and HIGH kernels' to the exact-f32 kernel's, the bf16
   layers 5-14 at B = 1,667, 209, 64, 32, 8 and 1 on each tensor-core tile
   (``mma_tile_phase``: outputs equal to ``sep_layer_mma_kernel``'s bit for
   bit and its outputs within the bf16 tolerance of the plain version,
   device time against the f32-activation floor, the library's pick,
   registers and spills), and one
   chunk's device time stage by stage, with the matmul frontend and with
   the fused log-mel on the int16 wire. The fused log-mel also at the
   benchmark cells' shape, one 1,667-patch chunk of the int16 wire: bits
   equal on two launches, to its f32 samples' and at every tile; against
   the plain version; device time beside the matmul frontend's and both
   bounds. Last, three classifies on the int16 wire under
   ``torch.profiler``: each ``buzzdetect.frontend`` span launches one
   kernel, ``logmel_fft_kernel``, and the wrapper counts one launch a
   call. YAMNet's layer 1 (``layer1_phase``) in exact f32 and bf16 at
   B = 5, 209 and 1,667: bits equal on two launches, to the kernel's
   replay in PyTorch and across batches; against the PyTorch chain it
   replaced; device time beside the chain's, cuDNN's ``F.conv2d`` alone
   and the bytes bound; one launch an embed, and no kernel in the embed
   but those of ``csrc/layer1.cu`` and ``csrc/sepconv.cu``. Then the
   Audio Spectrogram Transformer's kernels and one chunk of its cell
   (``ast_phase``);
3. the main paths end to end: ``buzzdetect_torch.analyze()`` on three
   30-minute 16 kHz WAV recordings (exact f32), then the CLI in process
   (``buzzdetect_torch.cli.main``, which must return None; the run's
   Analyzer is read through a spy on ``analysis.analyze``) on two
   10-minute recordings through a
   temporary models folder (``BUZZDETECT_DIR_MODELS``) that holds
   ``model_general_v3`` and two variants of it whose ``config_model.json``
   differ in one key each: (a) ``--bf16`` with ``"frontend": "pallas"``,
   (b) ``"conv_precision": "high"`` in f32. Each run: end reason, complete
   CSVs with the expected rows, the launch counts of its kernels (set to 0
   just before the run and read just after), one chunk's scores on the card
   against the same chunk on the CPU in the same mode (frontend 'auto' is
   the fused log-mel on the card: the analyze() run launches it once a
   chunk, and every CLI run launches it; every run launches layer 1 once
   a chunk); for the analyze()
   run also what it pays for its batches (its realtime factor and the
   device's idle share are the benchmark's): the conv launches by B
   (``<wrapper>.batches``), each wrapper's device time per launch at those
   B, and each B's share of the run's conv device time
   (``compare_builds.conv_shares``), with the histogram as
   ``compare_builds --launches`` takes it;
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
   against its plain version; (f) ``tools/int8_probe.py`` at 1000 patches:
   the embed in f32 and bf16 through the conv kernels and with int8
   pointwise products (``torch._int_mm``, dynamic and static activation
   scales), each one's deviation from f32, CUDA-event and device time and
   bound from the data sheet, and the conv kernels' launches over it;
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
   ``ChunkClassifier(conv='xla', frontend='xla')`` on one 200 s chunk of
   phase 3's first recording, at its 'auto' precision ('high', exact f32
   here) and in bf16: card against CPU, the hand kernels' launch counts
   over the call (all must be 0), and at B = 209 the conv stack's CUDA-event and device
   time beside the hand kernels' (layer 1 + ``fused_front`` +
   ``fused_tail``) and the whole classify beside the kernel path's; (b) the
   CLI on a bundle variant whose config says ``"conv": "xla"`` and
   ``"frontend": "xla"`` (the path a mesh takes) and on
   ``model_general_v3``, on phase 3's two CLI recordings: end reasons,
   realtime factor, no hand-kernel launch on the XLA run, one chunk card
   against CPU, the two runs' CSVs equal after 2-digit rounding; (c)
   ``analyze(devices=['cuda:0', 'cuda:0'])`` (two replicas, each with its
   own dispatch thread and CUDA stream) on phase 3's recordings: CSVs
   byte-identical to phase 3's, realtime factor; (d) two concurrent
   ``python -m buzzdetect_torch --host_shard I/2`` processes on one shared
   output folder: both exit 0 and the union of their CSVs is
   byte-identical to phase 3's; (e) ``mesh=`` over meshes that repeat the
   card (``make_mesh(devices=['cuda:0'] * n)``): ``ChunkClassifier(mesh=)``
   at full width on one 200.64 s chunk of phase 3's first recording (209
   patches) on 2 and 4 devices, with the matmul frontend and with
   ``frontend='pallas'``: scores against the same classifier without a
   mesh (``conv='xla'``, which a mesh resolves to) within 1e-4, the
   launches of one call (the log-mel once with ``frontend='pallas'``, no
   conv kernel), the classify's CUDA-event and device time beside one
   device's; ``analyze(mesh=)`` on phase 3's recordings: CSVs
   byte-identical to one device's on the XLA conv path and equal after
   2-digit rounding to phase 3's, realtime factor; on phase 7's corpus
   over a 2 x 2 ('data', 'model') mesh, the head-only fine-tune (the
   tool's embeddings, 5 epochs) against one device's, the first full
   step's gradients held leaf by leaf as phase 7b holds them and against
   one device's step, one step's time beside one device's, and the full
   fine-tune resumed after one epoch against the uninterrupted mesh run,
   bit for bit;
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
8. the serving export (``models/export.py``), the GUI's analysis child and
   the custom operators' dispatch, at the full width of
   ``model_general_v3`` on one 200.64 s chunk (209 patches) of phase 3's
   first recording: (a) a ``conv='xla'`` artifact for ``('cpu', 'cuda')``,
   traced on the CPU and loaded on the card; (b) a ``conv='pallas'``
   artifact for ``('cuda',)``, traced on the card; (c) the same for the
   ``"frontend": "pallas"`` bundle variant; (d) a ``conv='xla'`` artifact at
   ``framehop_prop=2.0``. Each: its bytes, export and load times, its
   kernel launches over 1 and 3 calls (launch counts set to 0 just before,
   read just after: ``fused_front`` and ``fused_tail`` once per call on
   (b) and (c), the log-mel too on (c), nothing on (a) and (d)), its scores
   against the live model built with the artifact's ``conv`` and
   ``conv_precision`` (1e-4), its rows against ``n_patches``, and its
   per-call time beside the live classify's (phases 2 and 6a); (e) the
   GUI's ``run_analysis`` in a ``spawn`` child on phase 3's recordings,
   with a queue for ``q_gui`` (through ``tests/tk_stub.py`` where tkinter
   does not import): exit 0 and CSVs byte-identical to phase 3's; (f) the
   conv kernels' host work per call now that the wrappers launch through
   the custom operators (``ops/library.py``): phase 2's CUDA-event time
   less device time, and the host time to enqueue one call at B = 5
   through the wrapper, the operator and the launcher alone; (g) the four
   examples of ``buzzdetect_torch/examples`` (``quickstart``,
   ``scale_out``, ``train_detector``, ``field_monitoring``) on the card;
9. one JSON line with every kernel's numbers (printed after phase 10);
10. the JAX package's kernel and pipeline suites on the card: (a) the grids
   of ``tests/test_pallas_conv.py`` and ``tests/test_pallas.py``:
   ``fused_front`` (layers 2-3 and 2-7), ``fused_tail`` from layers 8 and
   13 with pooling and the layer 4-7 block at B = 1, 2, 3, 5 and 8,
   ``fused_tail`` from 8 and 13 without pooling at B = 3, bf16 and HIGH at
   B = 3, and the fused log-mel on 1.0, 4.8 and 10.0 s: each against its
   plain version at phase 2's tolerances, each conv row equal bit for bit
   to the same rows at B = 209, its device time beside the plain
   version's and the cuDNN layer stack's (the matmul frontend's), and its
   bound by phase 2's formula; the exact-f32 rows also by ``queued_ms``
   (the call's kernels and gaps, queued behind a device sleep), kernel and
   cuDNN, warm and with the L2 flushed by a 128 MB write; (b) has gone
   with the JAX package's three front routes (the port runs one); (c) the
   modes of
   ``tests/test_pipeline.py`` through ``analyze()``: framehop 0.5 and 0.3,
   the mu-law wire and detections mode on a 300 s excerpt of phase 3's
   first recording against the port's CPU run of the same mode, batched
   dispatch (4 chunks per call) byte-identical to phase 3's CSVs, the batch
   path with ``"frontend": "pallas"`` launching the log-mel once per call,
   and a resume from a partial holding one chunk, byte-identical to phase
   3's CSV; (d) phase 8's ``conv='pallas'`` artifact loaded in a ``spawn``
   child with an empty build folder: it builds the kernels, and its scores
   equal the live model's;
11. the paths of the last JAX suites given twins (``tests/test_profile.py``,
   ``test_score_embeddings.py``, ``test_train.py``), at the full width of
   ``model_general_v3`` on phase 10c's 300 s excerpt of phase 3's first
   recording: (a) ``analyze(profile='field')``, ``analyze(profile=
   'strict')`` and ``analyze(strict_f32=True)`` on the card and on the
   CPU: end reason, the manifest's ``profile`` key, the resolved wire, the
   field profile's note in the run's log, the kernels' launches (one
   ``fused_front``, one ``fused_tail`` and one log-mel per chunk, exact
   f32), card CSV
   against CPU CSV after 2-digit rounding; (b) ``train.embed_corpus.
   embed_directory`` of the excerpt on the card and on the CPU at the
   default chunk length and at 2.0 s: the start grid on one 0.96 s stride
   across chunk boundaries, the kernels' launches (one of each, the
   log-mel's too, per chunk), the embeddings card against CPU, and for the 2.0 s run (1.92 s
   chunks, B = 2) what it pays for its batches, as phase 3's; then
   ``python -m buzzdetect_torch.tools.score_embeddings`` on the card's
   embeddings of both chunk lengths, and on the default ones with an
   ensemble bundle made by ``tools/build_ensemble`` (two copies of
   ``model_general_v3``),
   each CSV equal to ``analyze()``'s on the card after 2-digit rounding;
   (c) the installed CLI's form, ``sys.exit(buzzdetect_torch.cli.
   main([...]))``, in a child process on the card on phase 3's first
   recording: exit status 0, no Analyzer on stderr, its CSV
   byte-identical to phase 3's.

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
# phase 2's exact-f32 layers, each alone, at these B beside B = 209
LAYER_BATCHES = (1, 8)
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
           'probe': 'buzzdetect_torch/csrc/probe.cu',
           'attention': 'buzzdetect_torch/csrc/attention.cu',
           'epilogue': 'buzzdetect_torch/csrc/epilogue.cu',
           'layer1': 'buzzdetect_torch/csrc/layer1.cu'}
REPLACES = {'fused_front': 'buzzdetect_tpu/ops/pallas_conv.py:448',
            'fused_tail': 'buzzdetect_tpu/ops/pallas_conv.py:529',
            'log_mel': 'buzzdetect_tpu/ops/pallas_frontend.py:128',
            # no TPU kernel: the JAX package runs no transformer
            'attention': 'none (added for the Audio Spectrogram Transformer)',
            'bias_epilogue': 'none (added for the Audio Spectrogram '
                             'Transformer)',
            # no TPU kernel: the JAX package leaves layer 1 to XLA
            'layer1': 'none (buzzdetect_tpu/models/yamnet.py packed_l1 is '
                      'XLA)',
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
# the exact-f32 layers printed beside dot_f32 at their pointwise shape
DOT_LAYERS = (8, 9, 10, 11, 12, 14)
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
# the XLA path (conv='xla' and the matmul frontend, frontend='xla', as a
# mesh runs them): the bundle variant whose config asks for it, and the
# modes phase 6 runs it in: 'auto' precision (-> 'high', exact f32 on the
# card) and bf16, each with its classifier keywords
XLA_BUNDLE = ('model_general_v3_xla', {'conv': 'xla', 'frontend': 'xla'})
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
    # the AST model directory (a config, seeded weights), as it is
    shutil.copytree(os.path.join(ROOT, 'models', AST_MODEL),
                    os.path.join(models, AST_MODEL))
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
                                   frontend='xla', transfer_dtype='int16',
                                   **kw)
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


def cli_run(argv):
    """``buzzdetect_torch.cli.main(argv)`` in process. It must return None
    (the installed ``buzzdetect-torch`` script runs ``sys.exit(main())``,
    which exits 1 on any other value); the Analyzer of its run is kept by a
    spy on ``buzzdetect_torch.analysis.analyze`` and returned."""
    from buzzdetect_torch import analysis, cli
    real, seen = analysis.analyze, []

    def spy(**kw):
        seen.append(real(**kw))
        return seen[-1]

    analysis.analyze = spy
    try:
        rc = cli.main(argv)
    finally:
        analysis.analyze = real
    if rc is not None or len(seen) != 1:
        fail(f'cli.main returned {rc!r} after {len(seen)} analyze() calls; '
             f'the installed script would not exit 0')
    return seen[0]


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
    runs = {}
    for name in (MODEL, XLA_BUNDLE[0]):
        out = os.path.join(tmp, f'out_cli_{name}')
        reset_counts()
        t0 = time.perf_counter()
        result = cli_run(['--modelname', name, '--dir_audio', cli_audio,
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
    worst = csv_gap(*(d for _result, d, _c in runs.values()), cli_names)
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


# phase 6e, mesh=: the meshes of the classify (each repeats the one card),
# the ('data', 'model') mesh of the training steps, and the scores of a
# mesh against the same classifier on one device (tests/test_parallel.py's
# bound; exact f32 on both sides)
MESH_SIZES = (2, 4)
TRAIN_MESH = (2, 2)
MESH_ATOL = 1e-4


def csv_gap(dir_a, dir_b, names):
    """The largest |score difference| between the CSVs of ``names`` in two
    output folders, after their 2-digit rounding."""
    worst = 0.0
    for n in names:
        tables = []
        for d in (dir_a, dir_b):
            with open(os.path.join(d, f'{n}_buzzdetect.csv')) as f:
                tables.append(np.array([ln.split(',') for ln in
                                        f.read().splitlines()[1:]], float))
        worst = max(worst, float(np.abs(tables[0] - tables[1]).max()))
    return worst


def mesh_devices(n, device):
    """``n`` repeats of the first device of ``device``'s type."""
    return [('cuda:0' if device == 'cuda' else device)] * n


def mesh_classify_phase(arrays, cfg, path_audio, chunk_s, reset_counts,
                        read_counts, time_ms, device_ms, device='cuda'):
    """(e) ``ChunkClassifier(mesh=)`` at full width on one ``chunk_s`` chunk
    of ``path_audio``, on meshes of MESH_SIZES repeats of the card, with
    the matmul frontend and with ``frontend='pallas'``: the scores against
    the same classifier without a mesh (``conv='xla'``, which a mesh
    resolves to) within MESH_ATOL and against the default hand kernels;
    the launches of one call (set to 0 just before, read just after: the
    log-mel once with ``frontend='pallas'``, no conv kernel); the classify
    of a device-resident wire by CUDA events and device time beside the
    unmeshed XLA classify's. Returns {label: row}."""
    import torch
    from buzzdetect_torch.audio import build_track
    from buzzdetect_torch.models.classifier import ChunkClassifier
    from buzzdetect_torch.ops.frontend import padded_length
    from buzzdetect_torch.parallel import make_mesh
    track = build_track(path_audio, target_rate=16000)
    samples = track.read_s16(int(chunk_s * 16000))
    track.close()
    kernels = ChunkClassifier(arrays, device=device,
                              transfer_dtype='int16').predict(samples)
    rows = {}
    with torch.inference_mode():
        for frontend in ('xla', 'pallas'):
            kw = dict(device=device, transfer_dtype='int16',
                      frontend=frontend)
            one = ChunkClassifier(arrays, conv='xla', **kw)
            ref = one.predict(samples)
            wire = one._upload(one._pad_to(
                samples, padded_length(len(samples), cfg)))
            one_ms = time_ms(lambda: one.classify_resident(wire))
            one_dev = device_ms(lambda: one.classify_resident(wire))
            for n in MESH_SIZES:
                mesh = make_mesh(devices=mesh_devices(n, device),
                                 device=device)
                clf = ChunkClassifier(arrays, mesh=mesh, **kw)
                if (clf.conv, clf.conv_precision) != ('xla', 'high'):
                    fail(f'a mesh resolved to conv={clf.conv!r}, '
                         f'conv_precision={clf.conv_precision!r}')
                reset_counts()
                got = clf.predict(samples)
                counts = read_counts()
                want = {k: 0 for k in counts}
                want['log_mel'] = int(frontend == 'pallas')
                d = float(np.abs(got - ref).max())
                d_kernels = float(np.abs(got - kernels).max())
                row = dict(max_abs_err=d, ms=time_ms(
                    lambda: clf.classify_resident(wire)),
                    device_ms=device_ms(lambda: clf.classify_resident(wire)),
                    one_ms=one_ms, one_device_ms=one_dev)
                label = f'{n}-device mesh, frontend={frontend!r}'
                rows[label] = row
                print(f'(e) {label}: {got.shape[0]} patches, max |mesh - one '
                      f'device| = {d:.3g} (bound {MESH_ATOL}), against the '
                      f'hand kernels {d_kernels:.3g}; launches of one call '
                      f'{counts}; classify {row["ms"]:.4f} ms (device '
                      f'{row["device_ms"]:.4f}) against one device\'s '
                      f'{one_ms:.4f} ms (device {one_dev:.4f})', flush=True)
                if got.shape != ref.shape or d > MESH_ATOL:
                    fail(f'{label}: scores differ from one device by {d:.3g}')
                if counts != want:
                    fail(f'{label}: one call launched {counts}, not {want}')
    return rows


def mesh_analyze_phase(tmp, dir_audio, dir_out, names, reset_counts,
                       read_counts, device='cuda'):
    """(e) ``analyze(mesh=)`` on phase 3's recordings over the largest of
    MESH_SIZES: its CSVs byte-identical to one device's on the XLA conv
    path (the XLA_BUNDLE), and equal after their 2-digit rounding to phase
    3's in ``dir_out`` (one unit of the last digit); no hand conv kernel
    launched; its realtime factor."""
    import buzzdetect_torch
    from buzzdetect_torch.parallel import make_mesh
    single = os.path.join(tmp, 'out_mesh_single_xla')
    result = buzzdetect_torch.analyze(
        modelname=XLA_BUNDLE[0], dir_audio=dir_audio, dir_out=single,
        verbosity_print='WARNING', device=device)
    if result.coordinator.end_reason != 'completed':
        fail(f'the one-device XLA run ended {result.coordinator.end_reason!r}')
    n = MESH_SIZES[-1]
    mesh = make_mesh(devices=mesh_devices(n, device), device=device)
    out = os.path.join(tmp, 'out_mesh')
    reset_counts()
    t0 = time.perf_counter()
    result = buzzdetect_torch.analyze(
        modelname=MODEL, dir_audio=dir_audio, dir_out=out,
        verbosity_print='WARNING', device=device, mesh=mesh)
    wall = time.perf_counter() - t0
    counts = read_counts()
    reason = result.coordinator.end_reason
    audio_s = result.coordinator.audio_seconds_done
    print(f'(e) analyze(mesh={n} x {mesh.first()}): end reason {reason!r}, '
          f'{wall:.2f} s wall, {audio_s / wall:.1f} audio s per wall s, '
          f'kernel launches {counts}', flush=True)
    if reason != 'completed' or any(counts.values()):
        fail(f'analyze(mesh=) ended {reason!r} with launches {counts}')
    same_csvs(out, single, names, f'analyze(mesh={n} devices) against one '
              f'device on the XLA conv path')
    worst = csv_gap(out, dir_out, names)
    print(f'(e) analyze(mesh=) CSVs against phase 3\'s (the hand kernels): '
          f'max |d| = {worst:.3g} after 2-digit rounding (one unit of the '
          f'last digit allowed)', flush=True)
    if worst > 0.0101:
        fail(f'analyze(mesh=) CSVs differ from phase 3\'s by {worst:.3g}')


def mesh_train_phase(tmp, time_ms, device_ms, reset_counts, read_counts,
                     device='cuda'):
    """(e) Training on phase 7's corpus over a TRAIN_MESH ('data', 'model')
    mesh of repeats of the card: the tool's head-only fine-tune (its
    embeddings of the corpus, every frame labelled, HEAD_EPOCHS epochs) and
    its full fine-tune (FULL_EPOCHS epochs, batch FULL_BATCH) against the
    same on one device; the first full step's gradients held as phase 7b
    holds them (each leaf within GRAD_RTOL of its max |g| of float64 along
    the run's own ReLU branches, the mesh's recorded shard by shard and
    joined in clip order) and against the one-device step's; the mesh
    fine-tune resumed after one epoch against the uninterrupted mesh run,
    bit for bit; one full step's time against one device's."""
    import torch
    from buzzdetect_torch.models import yamnet
    from buzzdetect_torch.models.heads import init_head
    from buzzdetect_torch.models.weights import train_state_from_numpy
    from buzzdetect_torch.ops.frontend import FrontendConfig, log_mel_patches
    from buzzdetect_torch.parallel import make_mesh
    from buzzdetect_torch.train import trainer
    from buzzdetect_torch.train.annotations import (frames_to_labels,
                                                    load_events)
    from buzzdetect_torch.train.clips import (build_clip_dataset,
                                              train_full_model)
    from buzzdetect_torch.train.embed_corpus import (embed_directory,
                                                     load_embeddings)
    root = os.path.join(tmp, 'mesh_train')
    os.makedirs(root)
    audio, ann, idents = write_corpus(root)
    mesh = make_mesh(devices=mesh_devices(int(np.prod(TRAIN_MESH)), device),
                     shape=TRAIN_MESH, axes=('data', 'model'), device=device)
    events = load_events(ann)

    # head-only, as the tool trains it
    work = os.path.join(root, 'work')
    embed_directory(audio, work, modelname=MODEL, log=lambda *_: None,
                    device=device)
    embs, labs = [], []
    for ident in idents:
        starts, emb = load_embeddings(os.path.join(
            work, f'{ident}_embeddings.npz'))
        embs.append(emb)
        labs.append(frames_to_labels(starts, events.get(ident, []),
                                     TRAIN_CLASSES, framelength=0.96))
    emb, lab = np.concatenate(embs), np.concatenate(labs)
    heads = {}
    for name, m in (('mesh', mesh), ('one', None)):
        reset_counts()
        heads[name] = trainer.train_head(emb, lab, epochs=HEAD_EPOCHS,
                                         batch_size=min(1024, len(emb)),
                                         mesh=m, device=device)
    k, lr = len(heads['one'][1]), 1e-3
    d_loss = max(abs(a - b) / abs(b) for a, b in zip(heads['mesh'][1],
                                                     heads['one'][1]))
    d_params = max(float(np.abs(heads['mesh'][0][p] - v).max())
                   for p, v in heads['one'][0].items())
    print(f'(e) head-only on a {TRAIN_MESH} mesh, {len(emb)} frames, {k} '
          f'steps: losses {heads["mesh"][1][0]:.6g} -> '
          f'{heads["mesh"][1][-1]:.6g}, max relative |mesh - one device| '
          f'{d_loss:.3g} (bound 1e-5); params max |d| {d_params:.3g} '
          f'(bound {2 * k * 1e-5 * lr:.3g}: 2 k 1e-5 lr)', flush=True)
    if d_loss > 1e-5 or d_params > 2 * k * 1e-5 * lr:
        fail('the head-only fine-tune on a mesh differs from one device\'s')

    # the first full step from the seeded state, mesh against one device
    clips, labels = build_clip_dataset(audio, events, TRAIN_CLASSES,
                                       log=lambda *_: None)
    state = {'yamnet_raw': yamnet.init_raw_params(0),
             'head': init_head(yamnet.N_EMBEDDINGS, len(TRAIN_CLASSES))}
    w, y = clips[:FULL_BATCH], labels[:FULL_BATCH]
    wd, yd = torch.from_numpy(w).to(device), torch.from_numpy(y).to(device)
    steps = {}
    for name, m in (('mesh', mesh), ('one', None)):
        params, _opt = train_state_from_numpy(state, learning_rate=1e-3,
                                              device=device)
        branches = relu_branches()
        with trainer.training_flags():
            with branches:
                loss, _stats = trainer.full_loss(params, wd, yd,
                                                 FrontendConfig(), mesh=m)
            loss.backward()
        per_layer = len(branches.masks) // 27
        masks = [torch.cat(branches.masks[i * per_layer:(i + 1) * per_layer])
                 for i in range(27)]
        steps[name] = (float(loss.detach()), masks, {
            p: t.grad.cpu().numpy()
            for p, t in trainer.trainable_leaves(params)})
    patches = log_mel_patches(torch.from_numpy(w), FrontendConfig()).reshape(
        len(w), 96, 64).double()
    y64 = torch.from_numpy(y).double()
    g64, z64 = first_step_f64(state, patches, y64)
    shares, edges = {}, {}
    for name, (_loss, masks, grads) in steps.items():
        same, _z = first_step_f64(state, patches, y64, masks)
        shares[name] = {p: float(np.abs(grads[p] - same[p]).max())
                        / float(np.abs(same[p]).max()) for p in same}
        off = [(z > 0) != m.numpy() for z, m in zip(z64, masks)]
        edges[name] = (int(sum(o.sum() for o in off)), max(
            float(np.abs(z[o]).max(initial=0.0)) for z, o in zip(z64, off)))
    vs_one = {p: float(np.abs(steps['mesh'][2][p] - v).max())
              / float(np.abs(g64[p]).max()) for p, v in steps['one'][2].items()}
    agree = all(torch.equal(a, b) for a, b in zip(steps['mesh'][1],
                                                  steps['one'][1]))
    top = max(shares['mesh'], key=shares['mesh'].get)
    print(f'(e) first full step at B={len(w)} on a {TRAIN_MESH} mesh: loss '
          f'{steps["mesh"][0]:.7g}, one device {steps["one"][0]:.7g}; '
          f'against float64 on its own branches {shares["mesh"][top]:.3g} '
          f'({top}; one device: {max(shares["one"].values()):.3g}); '
          f'branches off float64\'s: mesh {edges["mesh"][0]} at |z| <= '
          f'{edges["mesh"][1]:.3g}, one device {edges["one"][0]} at |z| <= '
          f'{edges["one"][1]:.3g}; mesh against one device '
          f'{max(vs_one.values()):.3g} of max |g64| (branches '
          f'{"equal" if agree else "differ"})', flush=True)
    if abs(steps['mesh'][0] - steps['one'][0]) > 1e-5 * abs(steps['one'][0]) \
            or max(shares['mesh'].values()) > GRAD_RTOL \
            or edges['mesh'][1] > BRANCH_EDGE:
        fail('the mesh step\'s gradients are not float64\'s on their own '
             f'ReLU branches within {GRAD_RTOL} of each leaf\'s max |g|')

    # one step's time, mesh against one device
    times = {}
    for name, m in (('mesh', mesh), ('one', None)):
        params, opt = train_state_from_numpy(state, learning_rate=1e-3,
                                             device=device)
        step = trainer.make_full_train_step(opt, params, mesh=m)
        times[name] = (time_ms(lambda: step(wd, yd)),
                       device_ms(lambda: step(wd, yd)))
    print(f'(e) one full step, B={len(w)}: mesh {times["mesh"][0]:.4f} ms '
          f'(device {times["mesh"][1]:.4f}), one device '
          f'{times["one"][0]:.4f} ms (device {times["one"][1]:.4f})',
          flush=True)

    # the full fine-tune on the mesh, straight and resumed, and one device's
    kw = dict(learning_rate=1e-3, log=lambda *_: None, device=device)
    gold_raw, gold_head, gold = train_full_model(
        clips, labels, epochs=FULL_EPOCHS, mesh=mesh, **kw)
    one = train_full_model(clips, labels, epochs=FULL_EPOCHS, **kw)[2]
    ckpt = os.path.join(root, 'ckpt')
    train_full_model(clips, labels, epochs=FULL_EPOCHS - 1, mesh=mesh,
                     checkpoint_dir=ckpt, **kw)
    raw, head, losses = train_full_model(clips, labels, epochs=FULL_EPOCHS,
                                         mesh=mesh, checkpoint_dir=ckpt, **kw)
    same = losses == gold and all(
        np.array_equal(got[k], want[k]) for got, want in
        ((raw, gold_raw), (head, gold_head)) for k in want)
    print(f'(e) full fine-tune on the mesh, {len(clips)} clips, {len(gold)} '
          f'steps: loss {gold[0]:.6g} -> {gold[-1]:.6g} (one device '
          f'{one[0]:.6g} -> {one[-1]:.6g}); {FULL_EPOCHS - 1} epoch then a '
          f'resume to {FULL_EPOCHS} against {FULL_EPOCHS} straight: '
          f'{"bit-identical" if same else "DIFFERENT"} over '
          f'{len(raw) + len(head)} arrays', flush=True)
    if not same:
        fail('the resumed mesh fine-tune differs from the uninterrupted one')
    if not (np.isfinite(gold).all() and gold[-1] < gold[0]):
        fail('the mesh fine-tune\'s losses are not finite and falling')


def mesh_phase(tmp, arrays, cfg, dir_audio, dir_out, names, chunk_s,
               reset_counts, read_counts, time_ms, device_ms, device='cuda'):
    """Phase 6e, ``mesh=`` at full width: the classify, ``analyze()`` and
    training, each over meshes that repeat the card."""
    t0 = time.perf_counter()
    print(f'6e. mesh=: meshes of {MESH_SIZES} x the card for the classify '
          f'and analyze(), a {TRAIN_MESH} (data, model) mesh for training',
          flush=True)
    rows = mesh_classify_phase(arrays, cfg, os.path.join(dir_audio,
                                                         'rec0.wav'),
                               chunk_s, reset_counts, read_counts, time_ms,
                               device_ms, device)
    mesh_analyze_phase(tmp, dir_audio, dir_out, names, reset_counts,
                       read_counts, device)
    mesh_train_phase(tmp, time_ms, device_ms, reset_counts, read_counts,
                     device)
    print(f'6e. done in {time.perf_counter() - t0:.1f} s', flush=True)
    return rows


def int8_phase(reset_counts, read_counts, patches=1000, chunks=20,
               device='cuda'):
    """Phase 4f: ``tools/int8_probe.py`` at ``patches`` on the card: its
    four rows (f32 and bf16 through the hand kernels, int8 dynamic and
    static through ``torch._int_mm``), each's deviation from f32, time and
    bound, and the conv kernels' launches over it (the f32 and bf16 rows'
    embeds)."""
    from buzzdetect_torch.tools import int8_probe
    print(f'4f. the int8 probe at {patches} patches', flush=True)
    reset_counts()
    out = int8_probe.run(patches, chunks, device,
                         log=lambda line: print(f'(f) {line}', flush=True))
    counts = read_counts()
    print(f'(f) kernel launches over the probe: {counts}', flush=True)
    if counts['fused_front'] <= 0 or counts['fused_front[bf16]'] <= 0:
        fail('the int8 probe\'s f32 and bf16 rows never launched the conv '
             'kernels')
    for name in ('bf16', 'int8-dynamic', 'int8-static'):
        if not np.isfinite(out[name]['dev']) \
                or out[name]['dev'] > 0.1 * out['scale']:
            fail(f'the int8 probe\'s {name} row is {out[name]["dev"]:.3g} '
                 f'from f32')
    return out


def examples_phase(device='cuda'):
    """Phase 8g: the four examples of ``buzzdetect_torch/examples`` on the
    card, each its ``main(['--device', device])``, with their wall times."""
    from buzzdetect_torch.examples import (field_monitoring, quickstart,
                                           scale_out, train_detector)
    print('8g. the examples', flush=True)
    for example in (quickstart, scale_out, train_detector,
                    field_monitoring):
        name = example.__name__.rsplit('.', 1)[1]
        print(f'(g) python -m buzzdetect_torch.examples.{name}', flush=True)
        t0 = time.perf_counter()
        example.main(['--device', device])
        print(f'(g) {name}: {time.perf_counter() - t0:.2f} s wall',
              flush=True)


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
    epochs) on the corpus: the kernels' launches over it (all of them in
    the embedding stage: one ``fused_front``, one ``fused_tail`` and one
    log-mel per chunk embedded), one file's embeddings on the card against the same
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
              if k not in ('fused_front', 'fused_tail', 'log_mel') and v}
    if any(counts[k] != want for k in ('fused_front', 'fused_tail',
                                        'log_mel')) or others:
        fail(f'the embedding stage launched {counts}, not {want} '
             f'fused_front, fused_tail and log_mel')
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


# phase 8, the serving export: its cases, (label, modelname, export keywords,
# platforms) each; the launches each call of the loaded program must add
# (read_counts' names); and the artifact held against the live model
EXPORT_CASES = (
    ('xla', MODEL, {'conv': 'xla'}, ('cpu', 'cuda'), {}),
    ('pallas', MODEL, {'conv': 'pallas'}, ('cuda',),
     {'fused_front': 1, 'fused_tail': 1}),
    ('pallas, "frontend": "pallas"', 'model_general_v3_pallas',
     {'conv': 'pallas'}, ('cuda',),
     {'fused_front': 1, 'fused_tail': 1, 'log_mel': 1}),
    ('xla, framehop_prop=2.0', MODEL, {'conv': 'xla', 'framehop_prop': 2.0},
     ('cpu', 'cuda'), {}),
)
EXPORT_ATOL = 1e-4
EXPORT_CALLS = 3
# (f) host time to enqueue one call: calls per round, rounds (median)
DISPATCH_CALLS = 50
DISPATCH_ROUNDS = 7


def export_phase(torch, tmp, path_audio, chunk_s, ref_ms, reset_counts,
                 read_counts, time_ms, device='cuda'):
    """(a)-(d) Each of EXPORT_CASES: ``export_classifier`` for one
    ``chunk_s`` chunk, saved, loaded with ``load_exported`` on ``device``;
    the artifact's bytes, export and load times; its launch counts over
    EXPORT_CALLS calls (set to 0 just before, read just after), which must
    grow by the case's launches per call and by nothing else; its scores on
    one chunk of ``path_audio`` against the live model built with the
    artifact's ``conv`` and ``conv_precision`` (EXPORT_ATOL), rows equal to
    ``n_patches``; and its per-call time (whole call, numpy in and out, and
    the program alone on a resident wire) beside ``ref_ms[label]``, the
    live classify's. Returns {label: row}."""
    from buzzdetect_torch.audio import build_track
    from buzzdetect_torch.models.export import (
        export_classifier, load_exported, save_exported)
    from buzzdetect_torch.models.registry import load_model
    track = build_track(path_audio, target_rate=16000)
    samples = track.read_s16(int(round(chunk_s * 16000)))
    track.close()
    rows = {}
    for label, modelname, kw, platforms, per_call in EXPORT_CASES:
        t0 = time.perf_counter()
        blob, meta = export_classifier(modelname, chunk_seconds=chunk_s,
                                       platforms=platforms, **kw)
        export_s = time.perf_counter() - t0
        d = save_exported(os.path.join(tmp, 'export', label.split(',')[0]
                                       + str(len(rows))), blob, meta)
        t0 = time.perf_counter()
        call, meta = load_exported(d, device=device)
        load_s = time.perf_counter() - t0
        # the live model on the artifact's frontend: an export maps the
        # bundle's 'auto' to the matmul frontend, the card's classifier to
        # the fused log-mel
        live = load_model(modelname, initialize=True, device=device,
                          framehop_prop=kw.get('framehop_prop', 1.0),
                          conv=meta['conv'],
                          conv_precision=meta['conv_precision'],
                          frontend='pallas' if per_call.get('log_mel')
                          else 'xla').classifier
        want = live.predict(samples)
        wire = live._pad_to(samples, meta['input_samples'])
        reset_counts()
        got = call(wire)
        first = read_counts()
        for _ in range(EXPORT_CALLS - 1):
            call(wire)
        counts = read_counts()
        diff = float(np.abs(got - want).max()) if got.shape == want.shape \
            else float('inf')
        with torch.inference_mode():
            resident = torch.from_numpy(wire).to(device)
            row = dict(bytes=len(blob), export_s=export_s, load_s=load_s,
                       max_abs_diff=diff, n_patches=meta['n_patches'],
                       ms=time_ms(lambda: call(wire)),
                       program_ms=time_ms(lambda: call.program(resident)))
        rows[label] = dict(row, dir=d, wire=wire, want=want)
        print(f'export [{label}] ({meta["conv"]}, {meta["conv_precision"]}, '
              f'platforms {meta["platforms"]}, traced on '
              f'{"cpu" if "cpu" in platforms else device}): '
              f'{row["bytes"]} bytes, export {export_s:.2f} s, load '
              f'{load_s:.2f} s; {got.shape[0]} score rows for n_patches '
              f'{meta["n_patches"]}; max |artifact - live| = {diff:.3g} '
              f'(atol {EXPORT_ATOL}); kernel launches after one call '
              f'{first}, after {EXPORT_CALLS} {counts}; per call '
              f'{row["ms"]:.4f} ms (numpy in and out), the program on a '
              f'resident wire {row["program_ms"]:.4f} ms'
              + (f', beside the live classify\'s {ref_ms[label]:.4f} ms'
                 if label in ref_ms else ''), flush=True)
        if got.shape != (meta['n_patches'], len(meta['classes'])) \
                or got.shape != want.shape:
            fail(f'export [{label}]: {got.shape} score rows, live '
                 f'{want.shape}, n_patches {meta["n_patches"]}')
        if diff > EXPORT_ATOL:
            fail(f'export [{label}]: the artifact is {diff:.3g} from the live '
                 f'model')
        for n, calls in ((first, 1), (counts, EXPORT_CALLS)):
            expect = {k: calls * per_call.get(k, 0) for k in n}
            if n != expect:
                fail(f'export [{label}]: after {calls} calls the kernels '
                     f'launched {n}, expected {expect}')
    return rows


def gui_child(kwargs, q_gui, event_stop, stub):
    """The GUI's analysis child: ``gui.analysis.run_analysis`` in a spawn
    process, through ``tests/tk_stub.py`` where the machine has no tkinter
    (``gui.analysis`` imports it at import)."""
    sys.path.insert(0, ROOT)
    if stub:
        # by path: the checkout's tests/ has no __init__.py, so any
        # installed package named tests would shadow it
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            'tk_stub', os.path.join(ROOT, 'tests', 'tk_stub.py'))
        tk_stub = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tk_stub)
        tk_stub.install()
    from buzzdetect_torch.gui.analysis import run_analysis
    run_analysis(kwargs, q_gui, event_stop)


def gui_phase(tmp, dir_audio, dir_out, names, device='cuda'):
    """(e) The GUI's ``run_analysis`` in a ``spawn`` child (as the analysis
    window starts it) on phase 3's recordings, with a queue for ``q_gui``:
    it exits 0, its records reach the queue, and its CSVs are
    byte-identical to phase 3's in ``dir_out``. Every process started here
    is stopped before this returns."""
    import multiprocessing
    import queue as queue_mod
    tk = subprocess.run([sys.executable, '-c', 'import tkinter'],
                        capture_output=True, text=True, timeout=120)
    stub = tk.returncode != 0
    print('GUI: tkinter ' + ('imports here' if not stub else
                             'does not import here ('
                             + (tk.stderr.strip().splitlines() or ['?'])[-1]
                             + '); the child installs tests/tk_stub.py '
                             'before it imports gui.analysis'), flush=True)
    ctx = multiprocessing.get_context('spawn')
    q_gui, event_stop = ctx.Queue(), ctx.Event()
    out = os.path.join(tmp, 'out_gui')
    kwargs = dict(modelname=MODEL, dir_audio=dir_audio, dir_out=out,
                  verbosity_print='INFO', device=device)
    records = []
    t0 = time.perf_counter()
    child = ctx.Process(target=gui_child,
                        args=(kwargs, q_gui, event_stop, stub), daemon=True)
    child.start()
    try:
        deadline = time.monotonic() + HOST_TIMEOUT
        # drain while waiting: a child with an undrained log backlog blocks
        # on the queue's pipe at exit
        while time.monotonic() < deadline:
            try:
                records.append(q_gui.get(timeout=0.2))
            except queue_mod.Empty:
                if not child.is_alive():
                    break
        child.join(timeout=30)
    finally:
        if child.is_alive():
            child.kill()
            child.join()
    wall = time.perf_counter() - t0
    levels = collections.Counter(r.level_str for r in records)
    print(f'GUI run_analysis child: exit {child.exitcode}, {wall:.2f} s wall '
          f'(spawn, imports, kernel load and analysis), {len(records)} '
          f'records on q_gui {dict(levels)}', flush=True)
    failed = [r.message for r in records if 'analysis failed' in r.message]
    if child.exitcode != 0 or failed:
        fail(f'the GUI child exited {child.exitcode}: '
             f'{failed[-1][-2000:] if failed else ""}')
    if not any('Analysis complete' in r.message for r in records):
        fail('the GUI child sent no completion record on q_gui')
    same_csvs(out, dir_out, names, 'GUI run_analysis child')


def dispatch_phase(torch, params, x_front, x_tail, rows):
    """(f) The conv kernels' host work per call, now that the wrappers
    launch through the custom operators: phase 2's CUDA-event time less
    device time at B=209 (``rows``), and the host time to enqueue one call
    at ``x_front``/``x_tail``'s batch through the wrapper (checks, operator,
    launch), through the operator alone and through the launcher alone
    (``sepconv._launch``, no operator): the operator less the launcher is
    what the dispatcher adds. Medians of DISPATCH_ROUNDS rounds of
    DISPATCH_CALLS calls on the host clock, the card synchronized between
    rounds."""
    import statistics
    from buzzdetect_torch.ops import library, sepconv
    b = x_front.shape[0]
    print('host launch work per call (phase 2, CUDA events - device time, '
          'B=209, through the operators): ' + ', '.join(
              f'{k} {rows[k]["ms"] - rows[k]["device_ms"]:.4f} ms'
              for k in ('fused_front', 'fused_tail')), flush=True)
    out = {}
    for name, x, first, last, gap in (
            ('fused_front', x_front, 2, 8, False),
            ('fused_tail', x_tail, 8, 15, True)):
        specs = sepconv.tail_specs(first, last)
        operands = sepconv._check(params, x, specs, 'highest')
        flat = sepconv._flat(operands)
        op = getattr(library, name)
        wrapper = getattr(sepconv, name)
        extra = (gap,) if name == 'fused_tail' else ()
        routes = {
            'wrapper': lambda: wrapper(params, x, start_layer=first,
                                       stop_layer=last, mode='highest',
                                       **({'gap': gap} if extra else {})),
            'operator': lambda: op(x, flat, first, last, *extra, 'highest'),
            'launcher': lambda: sepconv._launch(operands, x, specs, gap,
                                                'highest')}
        for route, fn in routes.items():
            for _ in range(3):
                fn()
            per = []
            for _ in range(DISPATCH_ROUNDS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(DISPATCH_CALLS):
                    fn()
                per.append((time.perf_counter() - t0) / DISPATCH_CALLS * 1e3)
                torch.cuda.synchronize()
            out[name, route] = statistics.median(per)
        print(f'{name} B={b}, host ms to enqueue one call: wrapper '
              f'{out[name, "wrapper"]:.4f}, operator '
              f'{out[name, "operator"]:.4f}, launcher '
              f'{out[name, "launcher"]:.4f}; the dispatcher adds '
              f'{out[name, "operator"] - out[name, "launcher"]:.4f} ms',
              flush=True)
    return out


# phase 10, the JAX package's kernel and pipeline suites on the card. (a)
# the kernel grids of tests/test_pallas_conv.py: (label, wrapper, start
# layer, stop layer, gap, batches, modes) each, on phase 2's activations;
# and the log-mel lengths of tests/test_pallas.py
SMALL_BATCHES = (1, 2, 3, 5, 8)   # with B = 2, the 1.92 s embed's chunks
SUITE_CONV = (
    ('fused_front(2, 4)', 'front', 2, 4, False, SMALL_BATCHES, ('highest',)),
    ('fused_front(2, 8)', 'front', 2, 8, False, SMALL_BATCHES, ('highest',)),
    ('fused_tail(8)', 'tail', 8, None, True, SMALL_BATCHES, ('highest',)),
    ('fused_tail(8, gap=False)', 'tail', 8, None, False, (3,),
     ('highest',)),
    ('fused_tail(13)', 'tail', 13, None, True, SMALL_BATCHES,
     ('highest',)),
    ('fused_tail(13, gap=False)', 'tail', 13, None, False, (3,),
     ('highest',)),
    ('fused_tail(4, 8)', 'tail', 4, 8, False, SMALL_BATCHES, ('highest',)),
    ('fused_front(2, 8)', 'front', 2, 8, False, (3,), ('bf16', 'high')),
    ('fused_tail(8)', 'tail', 8, None, True, (3,), ('bf16', 'high')),
    ('fused_tail(13)', 'tail', 13, None, True, (3,), ('bf16', 'high')),
)
SUITE_SECONDS = (1.0, 4.8, 10.0)
# the cold timings of 10a: a write of FLUSH_BYTES (past the 50 MB L2)
# before each timed call, behind a QUEUE_CYCLES device sleep (~2 ms) that
# lets the host queue the flush and the call before the device reaches
# them (queued_ms)
FLUSH_BYTES = 128 << 20
QUEUE_CYCLES = 4_000_000
# (c) the pipeline suite's modes (tests/test_pipeline.py), each an
# analyze() of an excerpt of phase 3's first recording on the card and on
# the CPU; and the batched dispatch's chunks per batch
PIPELINE_MODES = (
    ('framehop 0.5', {'framehop_prop': 0.5}),
    ('framehop 0.3', {'framehop_prop': 0.3}),
    ('mu-law wire', {'transfer_dtype': 'mulaw'}),
    ('detections', {'precision': 0.95}),
)
EXCERPT_SECONDS = 300.0
BATCH_CHUNKS = 4
# (d) the fresh process's time limit (it builds csrc/sepconv.cu itself)
CHILD_TIMEOUT = 600

# phase 11, the last JAX suites' paths on the card. (a) the profile runs:
# (label, analyze keywords, the manifest's profile key (None: absent), the
# wire the run must resolve)
PROFILE_RUNS = (
    ("profile='field'", {'profile': 'field'}, 'field', 'mulaw'),
    ("profile='strict'", {'profile': 'strict'}, 'strict', 'float32'),
    ('strict_f32=True', {'strict_f32': True}, None, 'int16'),
)
# (b) embed_directory's chunk lengths, and the ensemble's two members
# (copies of model_general_v3) and its bundle
EMBED_CHUNKS = (200.0, 2.0)
ENSEMBLE = ('v3_member_a', 'v3_member_b', 'v3_duo')
# (c) the installed script's form, run in a child process with the CLI's
# arguments, and the time limit of each child of phase 11
CONSOLE_SCRIPT = ('import sys\n'
                  'from buzzdetect_torch.cli import main\n'
                  'sys.exit(main(sys.argv[1:]))\n')
PHASE11_TIMEOUT = 600


def logmel_work(n_frames, n_samples, sample_bytes):
    """(flops, bytes) of the log-mel of ``n_frames`` frames, as
    ``benchmark/roofline.frontend_flops`` counts its work: a 512-point real
    FFT a frame (2.5 N log2 N), the window, the magnitudes and the dense
    257 x 64 mel product; the samples read once and the log-mel written
    once."""
    flops = n_frames * (2.5 * 512 * 9 + 400 + 3 * 257 + 2 * 257 * 64)
    return flops, n_samples * sample_bytes + n_frames * 64 * 4


def log_mel_dft_bound(b, n_frames, row, f32_peak):
    """The same frames' bound as the dense-DFT design counted it (a 400 x
    514 product and the mel product a frame at the f32 peak), beside the
    kernel's device time of ``row``."""
    dft_ms = 1e3 * n_frames * 2 * (400 * 2 * 257 + 257 * 64) / f32_peak
    where = (f'; the kernel\'s device time {row["device_ms"]:.4f} ms is '
             f'{100 * dft_ms / row["device_ms"]:.1f}% of it'
             if row else '')
    print(f'  log_mel B={b}: the dense-DFT count\'s bound {dft_ms:.4f} ms '
          f'(8.25 GFLOP a 200 s chunk){where}', flush=True)


def log_mel_geometry(logmel, dev, label, n_frames, batch=1):
    g = logmel.geometry_on(dev, n_frames, batch)
    print(f'log_mel {label} ({n_frames} frames) geometry: FT {g.ft} frames a '
          f'block, {g.blocks} blocks of {g.threads} threads, grid {g.grid}; '
          f'busiest SM {g.busiest} frames against a mean of {g.mean:.1f} '
          f'({g.busiest / g.mean:.3f}x); {g.per_sm} blocks an SM at once',
          flush=True)
    return g


# the benchmark's chunk: 1,667 patches (1600.335 s) as the int16 wire
CHUNK_PATCHES = 1667


def log_mel_chunk_phase(torch, dev, cfg, f32_peak, bytes_peak, time_ms,
                        device_ms):
    """The fused log-mel at the benchmark cells' shape: one seeded
    1,667-patch chunk as the int16 wire, as the classifier hands it to the
    kernel. Two launches agree bit for bit, and with the f32 samples the
    wire stands for, and every tile (``logmel.FRAME_TILES``) gives the same
    bits; max |kernel - plain| at ATOL and RTOL; the kernel's, the plain
    version's, the matmul frontend's and an FFT log-mel's by
    ``torch.fft.rfft`` (the benchmark's plain reference's formulation;
    timed only, the port never calls it) times (CUDA events and device
    time), and the kernel's bound under both counts."""
    from buzzdetect_torch.models.classifier import _to_float
    from buzzdetect_torch.ops import frontend, logmel
    n = (frontend.min_waveform_samples(cfg)
         + (CHUNK_PATCHES - 1) * cfg.patch_hop_samples)
    rng = np.random.default_rng(1667)
    wire = torch.from_numpy(
        (rng.standard_normal(n) * 3277).clip(-32768, 32767).astype(np.int16)
        ).to(dev)
    samples = _to_float(wire)
    n_frames = 1 + (n - 400) // 160
    log_mel_geometry(logmel, dev, f'{CHUNK_PATCHES} patches', n_frames)
    got = logmel.log_mel_spectrogram_fused(wire, cfg)
    again = logmel.log_mel_spectrogram_fused(wire, cfg)
    from_f32 = logmel.log_mel_spectrogram_fused(samples, cfg)
    ref = logmel.log_mel_spectrogram_fused_plain(wire, cfg)
    tiles = {ft: logmel._launch(wire.reshape(1, -1), cfg, ft=ft)[0]
             for ft in logmel.FRAME_TILES}
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if not torch.equal(got, again):
        fail(f'log_mel {CHUNK_PATCHES} patches: two launches differ')
    if not torch.equal(got, from_f32):
        fail(f'log_mel {CHUNK_PATCHES} patches: the int16 wire and its f32 '
             f'samples differ')
    differ = [ft for ft, t in tiles.items() if not torch.equal(t, got)]
    if differ:
        fail(f'log_mel {CHUNK_PATCHES} patches: tiles {differ} differ from '
             f'the launch\'s')
    if not torch.allclose(got, ref, atol=ATOL, rtol=RTOL):
        fail(f'log_mel {CHUNK_PATCHES} patches disagrees with its plain '
             f'version: max |d| {err:.3g}')
    flops, n_bytes = logmel_work(n_frames, n, 2)
    fft_ms = 1e3 * max(flops / f32_peak, n_bytes / bytes_peak)
    dft_ms = 1e3 * n_frames * 2 * (400 * 2 * 257 + 257 * 64) / f32_peak
    kernel = lambda: logmel.log_mel_spectrogram_fused(wire, cfg)  # noqa
    plain = lambda: logmel.log_mel_spectrogram_fused_plain(wire, cfg)  # noqa
    library = lambda: frontend.log_mel_spectrogram(_to_float(wire), cfg)  # noqa
    hann = torch.from_numpy(logmel.fft_tables()[0] * 2).to(dev)
    mel = logmel._operands(cfg, dev)['mel']

    def rfft():
        frames = _to_float(wire).unfold(-1, 400, 160) * hann
        mag = torch.fft.rfft(frames, n=512).abs()
        return torch.log(mag @ mel + cfg.log_offset)
    t = {k: time_ms(fn) for k, fn in (('kernel', kernel), ('plain', plain),
                                       ('library', library), ('rfft', rfft))}
    d = {k: device_ms(fn) for k, fn in (('kernel', kernel),
                                         ('library', library),
                                         ('rfft', rfft))}
    print(f'kernel log_mel {CHUNK_PATCHES} patches (int16 wire): max |kernel '
          f'- plain| = {err:.3g} (atol {ATOL:.3g}, rtol {RTOL:.3g}); bits '
          f'equal on two launches, to the f32 samples\' and at every tile '
          f'{list(tiles)}; kernel {t["kernel"]:.4f} ms, plain '
          f'{t["plain"]:.4f} ms, matmul frontend {t["library"]:.4f} ms '
          f'(kernel / library {t["kernel"] / t["library"]:.2f}x)', flush=True)
    print(f'  log_mel {CHUNK_PATCHES} patches: device time (kernels only, '
          f'torch.profiler) kernel {d["kernel"]:.4f} ms, matmul frontend '
          f'{d["library"]:.4f} ms ({d["kernel"] / d["library"]:.3f}x), '
          f'torch.fft.rfft log-mel {t["rfft"]:.4f} ms (device '
          f'{d["rfft"]:.4f} ms, {d["kernel"] / d["rfft"]:.3f}x); '
          f'bound {fft_ms:.4f} ms by frontend_flops\' FFT count '
          f'({flops / 1e9:.2f} GFLOP, {n_bytes / 1e6:.1f} MB; '
          f'{100 * fft_ms / d["kernel"]:.1f}% of it), {dft_ms:.4f} ms by the '
          f'dense-DFT count ({100 * dft_ms / d["kernel"]:.1f}%)', flush=True)


# the bf16 layers that the wide tensor-core tile can take (F a multiple of
# 256), at the benchmark cells' chunk, a default 200 s chunk and the short
# files' and the watch's batches; how much slower than
# sep_layer_mma_kernel's tile the library's pick may time at B <= 209 (two
# tiles' device times alone, in one process, differ by up to 2% from run
# to run), and than the fastest tile at any batch
WIDE_LAYERS = tuple(range(5, 15))
WIDE_BATCHES = (CHUNK_PATCHES, 209, 64, 32, 8, 1)
WIDE_SLACK = 1.03
PICK_SLACK = 1.10


def mma_tile_phase(params, bytes_peak):
    """The bf16 layers 5-14 at each of WIDE_BATCHES on each tensor-core
    tile (``tools/mma_tiles.py``): sep_layer_mma_kernel's and the wide
    tile at 128 and 64 rows, each one's device time against the layer's
    floor (its f32 activations read and written once), the tile the
    library picks, sep_layer_mma_kernel's output against the layer's plain
    version at the bf16 tolerance, and each kernel's registers and spills
    (``nvcc -Xptxas -v``). Fails if a wide tile's outputs differ from
    sep_layer_mma_kernel's, if those differ from the plain version beyond
    the tolerance, if the wide kernel spills, if a pick at B <= 209 times
    slower than sep_layer_mma_kernel's tile by more than WIDE_SLACK, and
    if a pick times slower than the fastest tile by more than
    PICK_SLACK."""
    from buzzdetect_torch.tools import mma_tiles
    kernels = mma_tiles.resources()
    print('tensor-core conv kernels, registers a thread (spilled bytes '
          'stored / loaded): ' + ', '.join(
              f'{k["kernel"]} {k.get("registers")} ({k["spill_stores"]} / '
              f'{k["spill_loads"]})' for k in kernels), flush=True)
    spilled = [k['kernel'] for k in kernels
               if k['kernel'].startswith('sep_mma_wide_kernel')
               and (k['spill_stores'] or k['spill_loads'])]
    if spilled:
        fail(f'the wide tensor-core tile spills: {spilled}')
    rows = mma_tiles.layer_rows(params, WIDE_LAYERS, WIDE_BATCHES,
                                bytes_peak, tolerance=tolerance)
    for row in rows:
        print('  [bf16] ' + mma_tiles.row_line(row), flush=True)
        where = f'layer {row["layer"]} B={row["b"]}'
        if row['differ']:
            fail(f'{where}: the wide tile\'s outputs differ from '
                 f'sep_layer_mma_kernel\'s')
        err, atol, ok = row['plain']
        if not ok:
            fail(f'{where}: sep_layer_mma_kernel disagrees with the plain '
                 f'version: max |d| {err:.3g} (atol {atol:.3g})')
        ms = row['ms']
        picked = ms[row['pick']]
        if row['b'] <= 209 and picked > WIDE_SLACK * ms[0]:
            fail(f'{where}: the library\'s pick {picked:.4f} ms is slower '
                 f'than sep_layer_mma_kernel\'s {ms[0]:.4f} ms')
        if picked > PICK_SLACK * min(ms.values()):
            fail(f'{where}: the library\'s pick {picked:.4f} ms is slower '
                 f'than the fastest tile\'s {min(ms.values()):.4f} ms')
    for b in WIDE_BATCHES:
        group = [r for r in rows if r['b'] == b]
        today = sum(r['ms'][0] for r in group)
        picked = sum(r['ms'][r['pick']] for r in group)
        floor = sum(r['floor_ms'] for r in group)
        print(f'[bf16] layers 5-14 at B={b}: picked tiles {picked:.4f} ms, '
              f'sep_layer_mma_kernel\'s {today:.4f} ms, floor '
              f'{floor:.4f} ms', flush=True)


# YAMNet's layer 1 at the main path's batches: a ragged chunk, a default
# 200 s chunk and the benchmark cells' 1,667-patch chunk
LAYER1_BATCHES = (5, 209, CHUNK_PATCHES)


def layer1_work(b):
    """(FLOP, bytes) of YAMNet's layer 1 at ``b`` patches: 9 products and
    9 sums of each of the 48 x 32 x 32 outputs (the bias add counted with
    the sums); the patches read once, the taps and bias once, the NHWC
    output written once."""
    flops = 2 * 9 * b * 48 * 32 * 32
    return flops, 4 * (b * 96 * 64 + 9 * 32 + 32 + b * 48 * 32 * 32)


def layer1_phase(torch, dev, params, cfg, bytes_peak, time_ms, device_ms):
    """YAMNet's layer 1 (``ops/layer1.py``, ``csrc/layer1.cu``) on
    log-mel patches of a seeded waveform, in exact f32 and bf16, at B = 5,
    209 and 1,667 (the first patches of one 1,667-patch chunk): two
    launches agree bit for bit, equal ``layer1.replay`` (the kernel's steps
    in PyTorch) bit for bit, and the B = 5 and 209 rows equal the same rows
    inside B = 1,667; max |kernel - plain| (the PyTorch chain it replaced:
    pad, cuDNN ``F.conv2d`` with TF32 off, bias, ReLU, the bf16 roundings,
    the NHWC permute) within 1e-6 of each value's terms' magnitude in f32
    and one bf16 ulp of the larger value in bf16. Times by CUDA events and
    device time: the kernel, the plain chain and cuDNN's ``F.conv2d`` alone
    (the yardstick), beside the bytes bound. Then one ``yamnet.embed`` of
    the chunk in each mode under ``torch.profiler``: one layer-1 launch,
    and no kernel but those of ``csrc/layer1.cu`` and ``csrc/sepconv.cu``.
    Returns the kernels line's rows, at B = 1,667."""
    import torch.nn.functional as F
    from benchmark.program import kernel_matcher
    from buzzdetect_torch.models import yamnet
    from buzzdetect_torch.ops import frontend
    from buzzdetect_torch.ops import layer1 as layer1_lib
    from buzzdetect_torch.ops import sepconv
    n = (frontend.min_waveform_samples(cfg)
         + (CHUNK_PATCHES - 1) * cfg.patch_hop_samples)
    wav = np.random.default_rng(1667).standard_normal(n) * 0.1
    chunk = frontend.log_mel_patches(
        torch.from_numpy(wav.astype(np.float32)).to(dev), cfg).contiguous()
    kernel, bias = params['layer1/conv/kernel'], params['layer1/conv/bias']
    rows, whole = {}, {}
    for mode in ('highest', 'bf16'):
        name = 'layer1' if mode == 'highest' else f'layer1[{mode}]'
        for b in reversed(LAYER1_BATCHES):
            x = chunk[:b]
            kern = lambda: layer1_lib.layer1(kernel, bias, x, mode)  # noqa
            plain = lambda: layer1_lib.plain(kernel, bias, x, mode)  # noqa
            k_in = (sepconv.round_bf16(kernel) if mode == 'bf16'
                    else kernel)
            x_in = F.pad(x[:, None], (0, 1, 0, 1))
            library = lambda: F.conv2d(x_in, k_in, stride=2)  # noqa
            before = layer1_lib.layer1.launches
            got, again = kern(), kern()
            launched = layer1_lib.layer1.launches - before
            ref = plain()
            replayed = layer1_lib.replay(kernel, bias, x, mode)
            torch.cuda.synchronize()
            if launched != 2:
                fail(f'{name} B={b}: two calls launched {launched} times')
            if not torch.equal(got, again):
                fail(f'{name} B={b}: two launches on the same input differ')
            if not torch.equal(got, replayed):
                fail(f'{name} B={b}: the kernel differs from its replay, '
                     f'max |d| {float((got - replayed).abs().max()):.3g}')
            if b == CHUNK_PATCHES:
                whole[mode] = got
            elif not torch.equal(got, whole[mode][:b]):
                fail(f'{name}: B={b} rows differ from the same rows inside '
                     f'B={CHUNK_PATCHES}')
            gap = (got - ref).abs()
            err = float(gap.max())
            if mode == 'bf16':
                top = torch.maximum(got.abs(), ref.abs())
                ulp = torch.exp2(torch.floor(torch.log2(
                    top.clamp_min(1e-30))) - 7)
                ok = bool((gap <= torch.where(top == 0, 0, ulp)).all())
                limit = 'one bf16 ulp of the larger value'
            else:
                scale = layer1_lib.replay(kernel.abs(), bias.abs(), x.abs(),
                                          mode)
                ok = bool((gap <= 1e-6 * scale).all())
                limit = '1e-6 of the terms\' magnitude'
            flops, n_bytes = layer1_work(b)
            row = dict(max_abs_err=err, ms=time_ms(kern),
                       plain_ms=time_ms(plain), library_ms=time_ms(library),
                       device_ms=device_ms(kern),
                       plain_device_ms=device_ms(plain),
                       library_device_ms=device_ms(library),
                       **bound(0.0, n_bytes / bytes_peak))
            row['ratio'] = row['ms'] / row['library_ms']
            print(f'kernel {name} B={b}: max |kernel - plain| = {err:.3g} '
                  f'(within {limit}: {ok}); bits equal on two launches, to '
                  f'the replay and to B={CHUNK_PATCHES}\'s rows; kernel '
                  f'{row["ms"]:.4f} ms, plain {row["plain_ms"]:.4f} ms, '
                  f'cuDNN F.conv2d alone {row["library_ms"]:.4f} ms; device '
                  f'kernel {row["device_ms"]:.4f} ms, plain '
                  f'{row["plain_device_ms"]:.4f} ms, cuDNN '
                  f'{row["library_device_ms"]:.4f} ms; bound '
                  f'{row["bound_ms"]:.4f} ms ({row["bound_by"]}: '
                  f'{flops / 1e9:.3f} GFLOP, {n_bytes / 1e6:.1f} MB; '
                  f'{100 * row["bound_ms"] / row["device_ms"]:.1f}% of it); '
                  f'{layer1_lib.band_rows(b, layer1_lib._sms(dev.index or 0))}'
                  f' output rows a block', flush=True)
            if not ok:
                fail(f'{name} B={b} disagrees with its plain version: max '
                     f'|d| {err:.3g}')
            if b == CHUNK_PATCHES:
                rows[name] = row
        del whole[mode]
    # one embed of the chunk: one layer-1 launch, and only the two
    # libraries' kernels on the card
    ours = (kernel_matcher('layer1'), kernel_matcher('sepconv'))
    for mode in ('highest', 'bf16'):
        name = 'layer1' if mode == 'highest' else f'layer1[{mode}]'
        p = sepconv.pack_params(params, mode)
        yamnet.embed(p, chunk, 'bfloat16' if mode == 'bf16' else 'float32')
        torch.cuda.synchronize()
        before = layer1_lib.layer1.launches
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            yamnet.embed(p, chunk,
                         'bfloat16' if mode == 'bf16' else 'float32')
            torch.cuda.synchronize()
        launched = layer1_lib.layer1.launches - before
        names = collections.Counter(
            e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
        others = {k: v for k, v in names.items()
                  if not k.startswith(('Memcpy', 'Memset'))
                  and not any(m(k) for m in ours)}
        print(f'yamnet.embed [{mode}] B={CHUNK_PATCHES}: layer-1 launches '
              f'{launched}; device kernels {dict(names)}', flush=True)
        if launched != 1:
            fail(f'one embed launched layer 1 {launched} times')
        if others:
            fail(f'one embed [{mode}] ran kernels of neither library: '
                 f'{others}')
        rows[name]['launches'] = launched
    return rows


# the AST cell's chunk: 128 windows of 1,024 fbank frames (131,072 frames,
# 1310.735 s) and its attention: 12 heads of 64 over 1,214 tokens a window
AST_WINDOWS, AST_TOKENS, AST_HEADS = 128, 1214, 12
AST_MODEL = 'ast_audioset_10s'


def ast_phase(torch, dev, f32_peak, bf16_peak, bytes_peak, time_ms,
              device_ms):
    """The Audio Spectrogram Transformer's kernels and its classify on the
    card, at the benchmark cell's shapes:

    (a) the Kaldi fbank of one 128-window chunk (131,072 frames) of the
        int16 wire: bits equal on two launches, to its f32 samples' and at
        every tile; against the plain version; its time, device time and
        bound (``benchmark/roofline_ast.fbank_flops``) beside a
        ``torch.fft.rfft`` fbank's (timed only);
    (b) the attention kernel at 128 windows x 12 heads x 1,214 x 64 in bf16
        (every window against the plain version and the kernel's schedule
        replayed in PyTorch; its time, device time and bound beside the
        plain version's and ``F.scaled_dot_product_attention``'s, timed
        only, the port never calls it) and in f32 at 8 windows;
    (c) one chunk through ``load_model(AST_MODEL, bf16)``'s
        ``predict_async`` on the int16 wire: one fbank launch, 12 attention
        launches, the scores' gap to ``benchmark/reference/ast.py``'s bf16
        function and to the same chunk with the plain attention, each held
        to the cell's ``score_gap`` limit, and the chunk's time.

    Returns the kernels line's rows ('log_mel[kaldi]', 'attention')."""
    import torch.nn.functional as F
    from buzzdetect_torch.models.classifier import _to_float
    from buzzdetect_torch.ops import attention, epilogue, logmel
    sys.path.insert(0, ROOT)
    from benchmark import roofline_ast
    peak = {'f32': f32_peak, 'bf16': bf16_peak, 'bytes': bytes_peak}
    rows = {}

    # (a) the Kaldi fbank
    cfg = logmel.KaldiFbankConfig()
    n = 400 + (AST_WINDOWS * 1024 - 1) * 160
    rng = np.random.default_rng(1024)
    wire = torch.from_numpy(
        (rng.standard_normal(n) * 3277).clip(-32768, 32767).astype(np.int16)
        ).to(dev)
    n_frames = 1 + (n - 400) // 160
    g = logmel.geometry_on(dev, n_frames, 1, kind='kaldi')
    print(f'kaldi fbank ({n_frames} frames) geometry: FT {g.ft}, {g.blocks} '
          f'blocks of {g.threads} threads; {g.per_sm} blocks an SM at once',
          flush=True)
    got = logmel.log_mel_spectrogram_fused(wire, cfg)
    again = logmel.log_mel_spectrogram_fused(wire, cfg)
    from_f32 = logmel.log_mel_spectrogram_fused(_to_float(wire), cfg)
    ref = logmel.log_mel_spectrogram_fused_plain(wire, cfg)
    tiles = {ft: logmel._launch(wire.reshape(1, -1), cfg, ft=ft)[0]
             for ft in logmel.FRAME_TILES}
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if not torch.equal(got, again) or not torch.equal(got, from_f32):
        fail('kaldi fbank: two launches, or the wire and its f32 samples, '
             'differ')
    differ = [ft for ft, t in tiles.items() if not torch.equal(t, got)]
    if differ:
        fail(f'kaldi fbank: tiles {differ} differ from the launch\'s')
    # the log of a power: a band whose energy is a difference of larger
    # terms keeps f32's absolute error, relative to the frame's energy
    if not torch.allclose(got, ref, atol=1e-3, rtol=1e-5):
        fail(f'kaldi fbank disagrees with its plain version: max |d| {err:.3g}')
    # the benchmark's count: the mel product by the banks' nonzero weights;
    # the int16 wire read once, the f32 fbank written once
    flops = roofline_ast.fbank_flops(n_frames, cfg.mel_bands)
    n_bytes = n * 2 + n_frames * cfg.mel_bands * 4
    kernel = lambda: logmel.log_mel_spectrogram_fused(wire, cfg)  # noqa
    plain = lambda: logmel.log_mel_spectrogram_fused_plain(wire, cfg)  # noqa
    mel = logmel._operands(cfg, dev)['mel']
    hann = torch.hann_window(400, periodic=False, device=dev)

    def rfft():
        fr = _to_float(wire).unfold(-1, 400, 160)
        fr = fr - fr.mean(dim=-1, keepdim=True)
        fr = fr - 0.97 * torch.cat([fr[:, :1], fr[:, :-1]], dim=-1)
        power = torch.fft.rfft(fr * hann, n=512).abs().pow(2)
        return (torch.log(torch.clamp_min(power @ mel, cfg.floor))
                + cfg.shift) / cfg.divisor
    row = dict(max_abs_err=err, ms=time_ms(kernel), plain_ms=time_ms(plain),
               library_ms=time_ms(rfft), device_ms=device_ms(kernel),
               library_device_ms=device_ms(rfft),
               **bound(flops / f32_peak, n_bytes / bytes_peak))
    row['ratio'] = row['ms'] / row['library_ms']
    rows['log_mel[kaldi]'] = row
    print(f'kernel log_mel[kaldi] {n_frames} frames (int16 wire): max '
          f'|kernel - plain| = {err:.3g} (atol 1e-3); bits equal on two '
          f'launches, to the f32 samples\' and at every tile; kernel '
          f'{row["ms"]:.4f} ms (device {row["device_ms"]:.4f} ms), plain '
          f'{row["plain_ms"]:.4f} ms, torch.fft.rfft fbank '
          f'{row["library_ms"]:.4f} ms (device '
          f'{row["library_device_ms"]:.4f} ms); bound {row["bound_ms"]:.4f} '
          f'ms ({row["bound_by"]}: {flops / 1e9:.2f} GFLOP, '
          f'{n_bytes / 1e6:.1f} MB; '
          f'{100 * row["bound_ms"] / row["device_ms"]:.1f}% of it)',
          flush=True)

    # (b) attention
    c = AST_HEADS * attention.HEAD_DIM
    gen = torch.Generator(device=dev).manual_seed(1214)
    qkv = torch.randn(AST_WINDOWS, AST_TOKENS, 3 * c, device=dev,
                      generator=gen).to(torch.bfloat16)
    got = attention.attention(qkv, AST_HEADS)
    again = attention.attention(qkv, AST_HEADS)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        fail('attention: two launches on the same input differ')
    # every window against the plain version and the kernel's schedule
    # replayed in PyTorch, 16 windows at a time (a slice's f32 scores are
    # 1.1 GB)
    err = err_sched = top = 0.0
    for w in range(0, AST_WINDOWS, 16):
        part = qkv[w:w + 16].contiguous()
        ref = attention.attention_plain(part, AST_HEADS).float()
        sched = attention.attention_blocked(part, AST_HEADS).float()
        mine = got[w:w + 16].float()
        err = max(err, float((mine - ref).abs().max()))
        err_sched = max(err_sched, float((mine - sched).abs().max()))
        top = max(top, float(ref.abs().max()))
    del part, ref, sched, mine
    # bf16: the output's own rounding (2^-8 of the largest value) and P
    # rounded at the running maximum, not after the division
    atol = 2.0 ** -7 * top
    if err > atol:
        fail(f'attention bf16 disagrees with its plain version: max |d| '
             f'{err:.3g} > {atol:.3g}')
    q, k, v = (qkv.view(AST_WINDOWS, AST_TOKENS, 3, AST_HEADS, 64)
               .permute(2, 0, 3, 1, 4).contiguous().unbind(0))
    kernel = lambda: attention.attention(qkv, AST_HEADS)  # noqa
    plain = lambda: attention.attention_plain(qkv, AST_HEADS)  # noqa
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa
    flops = attention.attention_flops(AST_WINDOWS, AST_TOKENS, AST_HEADS)
    n_bytes = attention.attention_bytes(AST_WINDOWS, AST_TOKENS, AST_HEADS, 2)
    row = dict(max_abs_err=err, ms=time_ms(kernel),
               plain_ms=time_ms(plain),
               library_ms=time_ms(sdpa), device_ms=device_ms(kernel),
               library_device_ms=device_ms(sdpa), product='mma',
               **bound(flops / bf16_peak, n_bytes / bytes_peak))
    row['ratio'] = row['ms'] / row['library_ms']
    rows['attention'] = row
    print(f'kernel attention bf16 {AST_WINDOWS}x{AST_HEADS}x{AST_TOKENS}x64: '
          f'max |kernel - plain| = {err:.3g} (atol {atol:.3g}, every '
          f'window), |kernel - schedule in torch| = {err_sched:.3g}; bits '
          f'equal on '
          f'two launches; kernel {row["ms"]:.4f} ms (device '
          f'{row["device_ms"]:.4f} ms, {flops / row["device_ms"] / 1e9:.1f} '
          f'TFLOP/s), plain {row["plain_ms"]:.4f} ms, '
          f'sdpa {row["library_ms"]:.4f} ms (device '
          f'{row["library_device_ms"]:.4f} ms); bound {row["bound_ms"]:.4f} '
          f'ms ({row["bound_by"]}: {flops / 1e12:.2f} TFLOP, '
          f'{n_bytes / 1e9:.2f} GB; '
          f'{100 * row["bound_ms"] / row["device_ms"]:.1f}% of it)',
          flush=True)
    f32 = qkv[:8].float().contiguous()
    got32 = attention.attention(f32, AST_HEADS)
    ref32 = attention.attention_plain(f32, AST_HEADS)
    torch.cuda.synchronize()
    err32 = float((got32 - ref32).abs().max())
    if not torch.allclose(got32, ref32, atol=ATOL, rtol=RTOL):
        fail(f'attention f32 disagrees with its plain version: max |d| '
             f'{err32:.3g}')
    print(f'kernel attention f32 8x{AST_HEADS}x{AST_TOKENS}x64: max |kernel '
          f'- plain| = {err32:.3g} (atol {ATOL:.3g}); kernel '
          f'{time_ms(lambda: attention.attention(f32, AST_HEADS)):.4f} ms, '
          f'bound {1e3 * attention.attention_bound_s(8, AST_TOKENS, AST_HEADS, torch.float32, peak):.4f} ms',
          flush=True)
    del qkv, q, k, v, got, again, f32
    torch.cuda.empty_cache()

    # (b') the products' epilogues at fc1's shape (a 128-window block)
    m, cols = AST_WINDOWS * AST_TOKENS, 4 * c
    y = torch.randn(m, cols, device=dev, generator=gen) * 2
    bias = torch.randn(cols, device=dev, generator=gen)
    errs = {}
    for mode in epilogue.MODES:
        x = torch.randn(m, cols, device=dev, generator=gen)
        want = epilogue.plain(mode, y, bias, x.clone()).float()
        got = epilogue.apply(mode, y, bias, x.clone()).float()
        torch.cuda.synchronize()
        errs[mode] = float((got - want).abs().max())
        # bf16: one bf16 ulp where erff and the library's erf round apart
        # at a rounding edge; f32 sums: the same adds in the same order
        atol = 2.0 ** -7 * float(want.abs().max()) if mode != \
            'bias_residual' else 0.0
        if errs[mode] > atol:
            fail(f'bias_epilogue {mode} disagrees with its plain version: '
                 f'max |d| {errs[mode]:.3g}')
    n_bytes = m * cols * (4 + 2) + cols * 4
    x = torch.randn(m, cols, device=dev, generator=gen)
    kernel = lambda: epilogue.apply('bias_gelu_bf16', y, bias)  # noqa
    plain = lambda: epilogue.plain('bias_gelu_bf16', y, bias)  # noqa
    row = dict(max_abs_err=max(errs.values()), ms=time_ms(kernel),
               plain_ms=time_ms(plain), library_ms=time_ms(plain),
               device_ms=device_ms(kernel), library_device_ms=device_ms(plain),
               **bound(0.0, n_bytes / bytes_peak))
    row['ratio'] = row['ms'] / row['library_ms']
    resid_ms = device_ms(lambda: epilogue.apply('bias_residual', y, bias, x))
    rows_out = dict(row)
    print(f'kernel bias_epilogue {m}x{cols}: max |kernel - plain| '
          f'{errs}; bias_gelu_bf16 {row["ms"]:.4f} ms (device '
          f'{row["device_ms"]:.4f} ms) against the three PyTorch passes\' '
          f'{row["library_device_ms"]:.4f} ms; bound {row["bound_ms"]:.4f} ms '
          f'(bytes: {n_bytes / 1e9:.2f} GB; '
          f'{100 * row["bound_ms"] / row["device_ms"]:.1f}% of it); '
          f'bias_residual device {resid_ms:.4f} ms (bound '
          f'{1e3 * m * cols * 12 / bytes_peak:.4f} ms)', flush=True)
    rows['bias_epilogue'] = rows_out
    del y, x
    torch.cuda.empty_cache()

    # (c) one chunk through the model
    from buzzdetect_torch.models.registry import load_model
    from buzzdetect_torch.runtime.inferer import _start_host_copy
    from buzzdetect_torch.runtime.writer import _materialize
    from benchmark.manifest import load_module
    reference = load_module(os.path.join(ROOT, 'benchmark', 'reference',
                                         'ast.py'), 'chip_smoke_ast_ref')
    t0 = time.perf_counter()
    model = load_model(AST_MODEL, compute_dtype='bfloat16',
                       transfer_dtype='int16', device='cuda',
                       initialize=True)
    print(f'{AST_MODEL}: loaded in {time.perf_counter() - t0:.1f} s', flush=True)
    chunk = wire.cpu().numpy()
    logmel.log_mel_spectrogram_fused.launches = 0
    attention.attention.launches = 0
    epilogue.apply.launches = 0
    out, n_valid = model.predict_async(chunk)
    scores = _materialize(_start_host_copy(out), n_valid)
    counts = (logmel.log_mel_spectrogram_fused.launches,
              attention.attention.launches, epilogue.apply.launches)
    if counts != (1, 12, 48) or scores.shape != (AST_WINDOWS, 527):
        fail(f'{AST_MODEL}: one chunk gave {scores.shape} with (fbank, '
             f'attention, epilogue) launches {counts}, expected (1, 12, 48)')
    s, w = reference.load_weights(os.path.join(ROOT, 'models', AST_MODEL),
                                  dev)
    ref = reference.classify(w, s, chunk, 1.0, 'bf16')
    ref32 = reference.classify(w, s, chunk, 1.0, 'f32')
    gap = float(np.abs(scores - ref).max())
    # the benchmark cell's limit on the same gap
    with open(os.path.join(ROOT, 'benchmark', 'workloads',
                           'ast.bf16.long_chunks.pinned.json')) as f:
        limit = json.load(f)['limits']['score_gap']
    # the same chunk with the attention operator's plain version in the
    # kernel's place: how much of the gap is the kernel's
    from buzzdetect_torch.ops import library
    launch = library.attention
    library.attention = lambda qkv, heads, scale: attention.attention_plain(
        qkv, heads, scale)
    try:
        out, _ = model.predict_async(chunk)
        plain_scores = _materialize(_start_host_copy(out), n_valid)
    finally:
        library.attention = launch
    plain_gap = float(np.abs(plain_scores - ref).max())
    kernel_gap = float(np.abs(scores - plain_scores).max())
    if gap > limit or kernel_gap > limit:
        fail(f'{AST_MODEL}: one chunk\'s scores lie {gap:.3g} from the '
             f'reference\'s bf16 function and {kernel_gap:.3g} from the same '
             f'chunk with the plain attention, past the cell\'s score_gap '
             f'limit {limit:g}')
    chunk_ms = time_ms(lambda: model.predict_async(chunk), reps=5, warmup=2)
    print(f'{AST_MODEL} bf16, one {AST_WINDOWS}-window chunk on the int16 '
          f'wire: launches (fbank, attention, epilogue) {counts}; max |scores - '
          f'reference bf16| = {gap:.3g} (limit {limit:g}); with the plain '
          f'attention {plain_gap:.3g}; |kernel - plain attention scores| '
          f'{kernel_gap:.3g} (limit {limit:g}); |reference bf16 - reference f32| '
          f'{float(np.abs(ref - ref32).max()):.3g}; {chunk_ms:.2f} ms a '
          f'chunk ({(n / 16000) / (chunk_ms / 1e3):.0f} audio_s/s)',
          flush=True)
    rows['attention']['launches'] = counts[1]
    rows['log_mel[kaldi]']['launches'] = counts[0]
    rows['bias_epilogue']['launches'] = counts[2]
    return rows


def frontend_span_phase(torch, params, wire, cfg, calls=3, sessions=3):
    """The main path's frontend on the int16 wire launches one kernel, the
    fused log-mel's: ``calls`` classifies (frontend 'pallas', as 'auto'
    resolves on the card) under ``torch.profiler``, each device operation
    given to the ``buzzdetect.frontend`` span inside which its runtime call
    was made (the call's correlation id), as ``benchmark/spans.py`` does.
    A span holding any other operation fails the run; each must hold one
    ``logmel_fft_kernel``, in one of up to ``sessions`` sessions (the
    profiler can lose launches at a session's start). Also counts the
    wrapper's launches."""
    from buzzdetect_torch.models.classifier import _classify
    from buzzdetect_torch.ops import logmel
    cpu = torch.autograd.DeviceType.CPU
    with torch.inference_mode():
        _classify(params, wire, cfg, 'pallas')
        torch.cuda.synchronize()
    for session in range(1, sessions + 1):
        before = logmel.log_mel_spectrogram_fused.launches
        with torch.inference_mode(), torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                _classify(params, wire, cfg, 'pallas')
            torch.cuda.synchronize()
        launched = logmel.log_mel_spectrogram_fused.launches - before
        spans, calls_at, device = [], {}, []
        for e in prof.profiler.kineto_results.events():
            on_cpu = e.device_type() == cpu
            if e.is_user_annotation() and on_cpu \
                    and e.name() == 'buzzdetect.frontend':
                spans.append((e.start_ns(), e.start_ns() + e.duration_ns()))
            elif on_cpu and e.name().startswith('cu'):
                calls_at[e.correlation_id()] = e.start_ns()
            elif not on_cpu:
                device.append((e.correlation_id(), e.name()))
        held = [[name for corr, name in device
                 if corr in calls_at and a <= calls_at[corr] <= b]
                for a, b in sorted(spans)]
        print(f'buzzdetect.frontend on the int16 wire, {calls} classifies '
              f'(profiler session {session}): {len(spans)} spans holding '
              f'{[len(h) for h in held]} device operations '
              f'({sorted({n[:60] for h in held for n in h})}); log_mel '
              f'launches {launched}', flush=True)
        if launched != calls or any('logmel_fft_kernel' not in n
                                    for h in held for n in h):
            fail(f'the frontend span launched {held} in {calls} classifies '
                 f'(log_mel {launched} times)')
        if len(spans) == calls and all(len(h) == 1 for h in held):
            return
    fail(f'no profiler session of {sessions} recorded one log_mel kernel in '
         f'each frontend span')


def tolerance(mode, ref):
    """(atol, rtol) of a kernel against its plain version, as phase 2
    holds it: exact f32 (and HIGH, exact f32 in another order) at ATOL and
    RTOL, bf16 at 4 ulps of the largest value plus 2 relative."""
    if mode == 'bf16':
        return 4 * ULP_BF16 * float(ref.abs().max()), 2 * ULP_BF16
    return ATOL, RTOL


def read_batches():
    """The conv kernels' launches since the last reset by wrapper and batch,
    every layer range and mode summed: {'fused_front': {B: n},
    'fused_tail': {B: n}}."""
    from buzzdetect_torch.ops import sepconv
    out = {}
    for fn in (sepconv.fused_front, sepconv.fused_tail):
        batches = collections.Counter()
        for (_start, _stop, _mode, b), n in fn.batches.items():
            batches[b] += n
        out[fn.__name__] = dict(sorted(batches.items()))
    return out


def queued_ms(torch, fn, flush=None, reps=15):
    """Median milliseconds of ``fn()``'s kernels, the gaps between them
    included, by CUDA events that the device reaches only after the host
    has queued the whole call: each timing starts with a device sleep of
    QUEUE_CYCLES, then ``flush()`` (if given: L2 cold for ``fn``), the
    start event, ``fn()``, the end event. So the host's launch work, which
    exceeds a small call's device time, is not in the reading."""
    import statistics
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_CYCLES)
        if flush is not None:
            flush()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def geometry_phase():
    """The exact-f32 route's launch geometry: the library's own choice
    (``bz_sep_geometry`` for this card's ``bz_sep_card``) against its
    mirror ``sepconv.ffma_geometry``, every layer 2-14 at every B from 1
    to 209; prints the tail's geometry at SMALL_BATCHES and B = 209.
    Returns the card's (SMs, shared memory per SM, per block)."""
    from buzzdetect_torch.ops import sepconv
    card = sepconv.library_card()
    specs = sepconv.tail_specs(2, None)
    for b in range(1, BATCHES[0] + 1):
        got = sepconv.library_geometry(specs, b, card)
        for s, g in zip(specs, got):
            want = sepconv.ffma_geometry(s, b, card)
            if g != want:
                fail(f'layer {s.index} at B={b}: the library launches {g}, '
                     f'its mirror says {want}')
    print(f'exact-f32 geometry on {card[0]} SMs, {card[1]} B of shared '
          f'memory per SM, {card[2]} per block: bz_sep_geometry equals '
          f'sepconv.ffma_geometry on layers 2-14 at B = 1-{BATCHES[0]}',
          flush=True)
    for b in SMALL_BATCHES + BATCHES[:1]:
        print(f'  B={b}: ' + ', '.join(
            f'{s.index} {g.kernel} {g.bn}x{g.bm} ({g.blocks} blocks)'
            for s, g in zip(specs, sepconv.library_geometry(specs, b, card))),
            flush=True)
    return card


def batch_share_phase(label, hist, stack_ms):
    """What a run pays for its batches: ``hist`` ({wrapper: {B: launches}},
    ``read_batches``), each wrapper's device time per launch at each of
    those B (``stack_ms(wrapper, B)``), and each B's share of the run's conv
    device time by ``compare_builds.conv_shares`` (the tail's; the front's
    beside it). Prints the histogram as ``compare_builds --launches`` takes
    it. Returns the tail's shares."""
    from buzzdetect_torch.tools.compare_builds import conv_shares
    times = {w: {b: stack_ms(w, b) for b in h} for w, h in hist.items()}
    shares = conv_shares(hist, times)

    def by_batch(values, digits):
        return ', '.join(f'B={b} {v:.{digits}f}' for b, v in values.items())
    print(f'{label}: conv launches by B {hist}; device ms per launch '
          + '; '.join(f'{w} {by_batch(ts, 4)}' for w, ts in times.items())
          + '; share of the run\'s conv device time, fused_tail by B: '
          + by_batch(shares['fused_tail'], 4) + '; fused_front by B: '
          + by_batch(shares['fused_front'], 4), flush=True)
    launches = {w: {str(b): n for b, n in h.items()} for w, h in hist.items()}
    print(f'{label}: for compare_builds --launches: {json.dumps(launches)}',
          flush=True)
    return shares['fused_tail']


def suite_kernel_phase(torch, all_params, patches, wav, cfg, device_ms,
                       peaks):
    """(a) The kernel grids of the JAX package's kernel suites on the card:
    each SUITE_CONV case on the first B rows of phase 2's activations (its
    input from the plain stack), and the fused log-mel on SUITE_SECONDS of
    phase 2's waveform padded by ``frontend.pad_waveform``: each against
    its plain version at phase 2's tolerances, two launches bit-identical,
    each conv row equal to the same rows of the wrapper's output at B =
    209, its device time beside the plain version's and the cuDNN layer
    stack's (the matmul frontend's for the log-mel), and its bound by
    phase 2's formula from ``peaks`` (f32, bf16 and memory rates); exact
    f32 also by ``queued_ms``, kernel and cuDNN, warm and with the L2
    flushed. Returns {(label, mode, B): row}."""
    from buzzdetect_torch.models import yamnet
    from buzzdetect_torch.ops import frontend, logmel, sepconv
    from buzzdetect_torch.tools.roofline import library_stack, library_weights
    rows = {}
    f32_peak, bf16_peak, bytes_peak = peaks

    def hold(name, got, again, ref, mode, run_kernel, run_plain, run_library,
             work):
        err = float((got - ref).abs().max())
        atol, rtol = tolerance(mode, ref)
        row = dict(max_abs_err=err, device_ms=device_ms(run_kernel),
                   plain_device_ms=device_ms(run_plain),
                   library_device_ms=device_ms(run_library), **bound(*work))
        print(f'(a) {name}: max |kernel - plain| = {err:.3g} (atol '
              f'{atol:.3g}, rtol {rtol:.3g}); device time kernel '
              f'{row["device_ms"]:.4f} ms, plain '
              f'{row["plain_device_ms"]:.4f} ms, library '
              f'{row["library_device_ms"]:.4f} ms (kernel / library '
              f'{row["device_ms"] / row["library_device_ms"]:.2f}x); bound '
              f'{row["bound_ms"]:.3g} ms ({row["bound_by"]}; kernel '
              f'{row["device_ms"] / row["bound_ms"]:.1f}x)', flush=True)
        if not torch.allclose(got, ref, atol=atol, rtol=rtol):
            fail(f'{name} disagrees with its plain version: max |d| '
                 f'{err:.3g}')
        if not torch.equal(got, again):
            fail(f'{name}: two launches on the same input differ')
        return row

    print('10a. the kernel grids of tests/test_pallas_conv.py and '
          'tests/test_pallas.py', flush=True)
    flush_buf = torch.empty(FLUSH_BYTES // 4, device=patches.device)
    for label, which, start, stop, gap, batches, modes in SUITE_CONV:
        for mode in modes:
            params = sepconv.pack_params(all_params['yamnet'], mode)
            x = yamnet.layer1(params, patches, mode)
            if start > 2:
                s0 = sepconv.tail_specs(start)[0]
                x = sepconv.fused_tail_plain(
                    params, x, start_layer=2, stop_layer=start, gap=False,
                    mode=mode).reshape(-1, s0.h, s0.w, s0.c_in)
            specs = sepconv.tail_specs(start, stop)
            kw = dict(start_layer=start, stop_layer=stop, mode=mode)
            if which == 'front':
                wrapper, plain = (sepconv.fused_front,
                                  sepconv.fused_front_plain)
            else:
                wrapper, plain = sepconv.fused_tail, sepconv.fused_tail_plain
                kw['gap'] = gap
            lib_dtype = torch.bfloat16 if mode == 'bf16' else torch.float32
            lib_w = library_weights(params, specs, lib_dtype)
            # the same patches inside one 209-patch chunk, on the wide tile
            whole = wrapper(params, x, **kw)
            for b in batches:
                xb = x[:b].contiguous()
                x_nchw = xb.permute(0, 3, 1, 2).contiguous().to(lib_dtype)
                got = wrapper(params, xb, **kw)
                again = wrapper(params, xb, **kw)
                torch.cuda.synchronize()
                if not torch.equal(got, whole[:b]):
                    # per-patch results must not depend on the batch
                    fail(f'{label} [{mode}] B={b}: rows differ from the same '
                         f'rows inside B={x.shape[0]}')
                pw_f, dw_f, n_bytes = stack_work(specs, b, gap, mode)
                t_ops = ((pw_f + dw_f) / f32_peak if mode == 'highest'
                         else max(pw_f / bf16_peak, dw_f / f32_peak))
                run_kernel = (lambda xb=xb: wrapper(params, xb, **kw))
                run_library = (lambda x_nchw=x_nchw: library_stack(
                    lib_w, x_nchw, specs, gap))
                row = rows[label, mode, b] = hold(
                    f'{label} [{mode}] B={b}', got, again,
                    plain(params, xb, **kw), mode, run_kernel,
                    lambda: plain(params, xb, **kw), run_library,
                    (t_ops, n_bytes / bytes_peak))
                if mode != 'highest':
                    continue
                # queued on the device: warm, and with the L2 flushed
                for key, flush in (('warm', None), ('cold', flush_buf.zero_)):
                    row[f'{key}_ms'] = queued_ms(torch, run_kernel, flush)
                    row[f'{key}_library_ms'] = queued_ms(torch, run_library,
                                                         flush)
                print(f'    queued: kernel {row["warm_ms"]:.4f} ms warm, '
                      f'{row["cold_ms"]:.4f} ms with L2 flushed; cuDNN '
                      f'{row["warm_library_ms"]:.4f} / '
                      f'{row["cold_library_ms"]:.4f} ms (kernel / cuDNN '
                      f'{row["warm_ms"] / row["warm_library_ms"]:.2f}x warm, '
                      f'{row["cold_ms"] / row["cold_library_ms"]:.2f}x '
                      f'cold); B independent: rows equal to B='
                      f'{x.shape[0]}\'s', flush=True)
    for seconds in SUITE_SECONDS:
        w = frontend.pad_waveform(wav[:int(seconds * 16000)], cfg)
        got = logmel.log_mel_spectrogram_fused(w, cfg)
        again = logmel.log_mel_spectrogram_fused(w, cfg)
        torch.cuda.synchronize()
        # phase 2's count (logmel_work): each frame's FFT, window,
        # magnitudes and dense mel product; samples in and log-mel out once
        n_frames = 1 + (w.shape[0] - 400) // 160
        flops, n_bytes = logmel_work(n_frames, w.shape[0], 4)
        rows['log_mel', seconds, 1] = hold(
            f'log_mel {seconds} s ({got.shape[-2]} frames)', got, again,
            logmel.log_mel_spectrogram_fused_plain(w, cfg), 'highest',
            lambda: logmel.log_mel_spectrogram_fused(w, cfg),
            lambda: logmel.log_mel_spectrogram_fused_plain(w, cfg),
            lambda: frontend.log_mel_spectrogram(w, cfg),
            (flops / f32_peak, n_bytes / bytes_peak))
    return rows


def file_bytes(dir_out, name):
    with open(os.path.join(dir_out, f'{name}_buzzdetect.csv'), 'rb') as f:
        return f.read()


def write_excerpt(path_audio, path_out, seconds):
    """The first ``seconds`` of a 16 kHz PCM16 WAV as its own WAV."""
    with wave.open(path_audio, 'rb') as r:
        params = r.getparams()
        frames = r.readframes(int(seconds * params.framerate))
    with wave.open(path_out, 'wb') as w:
        w.setparams(params)
        w.writeframes(frames)


def pipeline_modes_phase(tmp, dir_audio, dir_out, names, seconds, chunk_s,
                         reset_counts, read_counts, device='cuda'):
    """(c) The pipeline suite's modes through ``analyze()`` on ``device``:
    each of PIPELINE_MODES on an excerpt (EXCERPT_SECONDS) of phase 3's
    first recording (phase 3's are ``seconds`` long), held against the port's CPU run of the same mode
    (equal after 2-digit rounding; detections equal), with the framehop
    modes' time grid; batched dispatch (BATCH_CHUNKS chunks per call) on
    phase 3's recordings, byte-identical to phase 3's unbatched CSVs in
    ``dir_out``; the batch path with the ``"frontend": "pallas"`` variant,
    whose log-mel must launch once per batched call; and a resume from a
    partial holding the second chunk of phase 3's first recording, which
    must reproduce phase 3's CSV byte for byte. Returns the excerpt's
    folder."""
    import buzzdetect_torch
    from buzzdetect_torch.ops.frontend import FrontendConfig
    from buzzdetect_torch.write.coverage import gaps_to_chunklist
    print('10c. the pipeline suite\'s modes through analyze()', flush=True)

    def run_analyze(out, what, **kw):
        kw.setdefault('device', device)
        kw.setdefault('modelname', MODEL)
        reset_counts()
        t0 = time.perf_counter()
        result = buzzdetect_torch.analyze(dir_out=out,
                                          verbosity_print='WARNING', **kw)
        wall = time.perf_counter() - t0
        counts = read_counts()
        reason = result.coordinator.end_reason
        audio_s = result.coordinator.audio_seconds_done
        print(f'(c) {what} on {kw["device"]}: end reason {reason!r}, '
              f'{wall:.2f} s wall, {audio_s / wall:.1f} audio s per wall s, '
              f'kernel launches {counts}', flush=True)
        if reason != 'completed':
            fail(f'{what} on {kw["device"]} ended {reason!r}')
        return counts, audio_s

    excerpt = os.path.join(tmp, 'excerpt')
    os.makedirs(excerpt)
    write_excerpt(os.path.join(dir_audio, f'{names[0]}.wav'),
                  os.path.join(excerpt, f'{names[0]}.wav'), EXCERPT_SECONDS)
    for i, (label, kw) in enumerate(PIPELINE_MODES):
        outs = [os.path.join(tmp, f'out_mode{i}_{k}') for k in ('run',
                                                                 'cpu')]
        for out, d in zip(outs, (device, 'cpu')):
            run_analyze(out, f'{label}, {EXCERPT_SECONDS:g} s excerpt',
                        dir_audio=excerpt, device=d, **kw)
        worst = csv_gap(*outs, names[:1])
        with open(os.path.join(outs[0], f'{names[0]}_buzzdetect.csv')) as f:
            lines = f.read().splitlines()
        starts = [float(ln.split(',')[0]) for ln in lines[1:4]]
        print(f'(c) {label}: header {lines[0][:60]}...; first starts '
              f'{starts}; card against CPU max |d| = {worst:.3g} after '
              f'2-digit rounding', flush=True)
        if 'framehop_prop' in kw:
            hop = FrontendConfig().with_framehop(
                kw['framehop_prop']).patch_hop_seconds
            if not np.allclose(starts, np.round(np.arange(3) * hop, 2)):
                fail(f'{label}: the time grid starts {starts}, hop {hop}')
        if 'precision' in kw and (lines[0] != 'start,detections_ins_buzz'
                                  or worst != 0):
            fail(f'{label}: header {lines[0]!r}, card against CPU {worst}')
        if worst > 0.0101:
            fail(f'{label}: card and CPU CSVs differ by {worst:.3g}')

    chunks = len(gaps_to_chunklist([(0.0, seconds)], chunk_s))
    out = os.path.join(tmp, 'out_batched')
    counts, _ = run_analyze(out, f'batch_chunks={BATCH_CHUNKS}',
                         dir_audio=dir_audio, batch_chunks=BATCH_CHUNKS,
                         n_streamers=BATCH_CHUNKS)
    if not 0 < counts['fused_front'] < len(names) * chunks:
        fail(f'batch_chunks={BATCH_CHUNKS}: {counts["fused_front"]} calls '
             f'for {len(names) * chunks} chunks')
    same_csvs(out, dir_out, names, f'batch_chunks={BATCH_CHUNKS} against '
              f'the unbatched run')
    variant = 'model_general_v3_pallas'
    out = os.path.join(tmp, 'out_batched_pallas')
    counts, _ = run_analyze(out, f'{variant} ("frontend": "pallas"), '
                         f'batch_chunks={BATCH_CHUNKS}', modelname=variant,
                         dir_audio=dir_audio, batch_chunks=BATCH_CHUNKS,
                         n_streamers=BATCH_CHUNKS)
    calls = counts['fused_front']
    worst = csv_gap(out, dir_out, names)
    print(f'(c) the batch path with "frontend": "pallas": {calls} batched '
          f'calls for {len(names) * chunks} chunks, log_mel launched '
          f'{counts["log_mel"]} times; CSVs against phase 3\'s max |d| = '
          f'{worst:.3g} after 2-digit rounding', flush=True)
    if not (0 < calls < len(names) * chunks and counts['log_mel'] == calls):
        fail(f'the batch path with "frontend": "pallas" launched log_mel '
             f'{counts["log_mel"]} times in {calls} calls')
    if worst > 0.0101:
        fail(f'the pallas-frontend batch CSVs differ from phase 3\'s by '
             f'{worst:.3g}')

    resume_audio = os.path.join(tmp, 'resume_audio')
    resume_out = os.path.join(tmp, 'out_resume')
    os.makedirs(resume_audio)
    os.makedirs(resume_out)
    name = names[0]
    os.symlink(os.path.join(dir_audio, f'{name}.wav'),
               os.path.join(resume_audio, f'{name}.wav'))
    with open(os.path.join(dir_out, f'{name}_buzzdetect.csv')) as f:
        lines = f.read().splitlines(keepends=True)
    per_chunk = int(round(chunk_s / 0.96))
    with open(os.path.join(resume_out, f'{name}_buzzpart.csv'), 'w') as f:
        f.write(lines[0])
        f.writelines(lines[1 + per_chunk:1 + 2 * per_chunk])
    shutil.copy(os.path.join(dir_out, 'buzzdetect_manifest.json'),
                resume_out)
    _, audio_s = run_analyze(resume_out, f'resume of {name} from a '
                             f'partial holding its second chunk',
                             dir_audio=resume_audio)
    if abs(audio_s - (seconds - chunk_s)) > 0.01:
        fail(f'the resume analyzed {audio_s} s of audio, expected all but '
             f'the partial\'s {chunk_s} s of {seconds}')
    if os.path.exists(os.path.join(resume_out, f'{name}_buzzpart.csv')):
        fail('the resume left its partial behind')
    same_csvs(resume_out, dir_out, names[:1], 'the resumed run')
    return excerpt


def artifact_child(path, wire, dir_build, q):
    """A fresh process that loads the ``conv='pallas'`` artifact at
    ``path`` on the card, building ``csrc/sepconv.cu`` into the empty
    ``dir_build`` at its first call, and puts (scores, load s, first call s
    with the build, the conv kernels' launches, the libraries built) on
    ``q``."""
    sys.path.insert(0, ROOT)
    from buzzdetect_torch.ops import _build, sepconv
    _build.DIR_BUILD = dir_build
    from buzzdetect_torch.models.export import load_exported
    t0 = time.perf_counter()
    call, _meta = load_exported(path, device='cuda')
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scores = call(wire)
    call_s = time.perf_counter() - t0
    q.put((scores, load_s, call_s,
           {'fused_front': dict(sepconv.fused_front.launches),
            'fused_tail': dict(sepconv.fused_tail.launches)},
           sorted(f for f in os.listdir(dir_build) if f.endswith('.so'))))


def fresh_artifact_phase(tmp, row):
    """(d) Phase 8's ``conv='pallas'`` artifact (``row``: its folder, the
    wire it was called on and the live model's scores) loaded in a
    ``spawn`` child that never built the kernels (an empty build folder):
    it must build them, launch each conv kernel once, and give the live
    model's scores exactly. The child is stopped before this returns."""
    import multiprocessing
    import queue as queue_mod
    print('10d. the conv=\'pallas\' artifact in a fresh process',
          flush=True)
    ctx = multiprocessing.get_context('spawn')
    q = ctx.Queue()
    dir_build = os.path.join(tmp, 'fresh_build')
    os.makedirs(dir_build)
    child = ctx.Process(target=artifact_child,
                        args=(row['dir'], row['wire'], dir_build, q),
                        daemon=True)
    t0 = time.perf_counter()
    child.start()
    try:
        got = q.get(timeout=CHILD_TIMEOUT)
        child.join(timeout=60)
    except queue_mod.Empty:
        fail(f'the fresh process gave no scores in {CHILD_TIMEOUT} s '
             f'(exit {child.exitcode})')
    finally:
        if child.is_alive():
            child.kill()
            child.join()
    scores, load_s, call_s, launches, built = got
    diff = float(np.abs(scores - row['want']).max())
    print(f'(d) fresh spawn child: exit {child.exitcode}, '
          f'{time.perf_counter() - t0:.2f} s wall; load {load_s:.2f} s, '
          f'first call {call_s:.2f} s (the build included); built {built}; '
          f'launches {launches}; max |artifact - live| = {diff:.3g}',
          flush=True)
    if child.exitcode != 0 or not built:
        fail(f'the fresh process exited {child.exitcode}, built {built}')
    if (launches['fused_front']['highest'] != 1
            or launches['fused_tail']['highest'] != 1):
        fail(f'the fresh process launched {launches}')
    if diff != 0:
        fail(f'the fresh process\'s scores are {diff:.3g} from the live '
             f'model\'s')


def profile_phase(tmp, excerpt, name, chunk_s, reset_counts, read_counts,
                  device='cuda'):
    """(a) PROFILE_RUNS through ``analyze()`` on ``excerpt`` (phase 10c's
    folder holding ``name``), on ``device`` and on the CPU: end reason, the
    manifest's profile key, the resolved wire, the field note in the run's
    log, the kernels' launches on ``device`` (exact f32: ``fused_front``,
    ``fused_tail`` and the log-mel, one of each per ``chunk_s`` chunk and one per dispatch thread's warmup, a nominal
    chunk at its start), and the two CSVs equal after their 2-digit
    rounding (one unit of the last digit: a value within f32 rounding of a
    rounding edge may print the other way)."""
    import buzzdetect_torch
    from buzzdetect_torch.write.coverage import gaps_to_chunklist
    print('11a. the deployment profiles through analyze()', flush=True)
    chunks = len(gaps_to_chunklist([(0.0, EXCERPT_SECONDS)], chunk_s))
    for i, (label, kw, key, wire) in enumerate(PROFILE_RUNS):
        outs = [os.path.join(tmp, f'out_profile{i}_{k}')
                for k in ('run', 'cpu')]
        for out, d in zip(outs, (device, 'cpu')):
            reset_counts()
            t0 = time.perf_counter()
            result = buzzdetect_torch.analyze(
                modelname=MODEL, dir_audio=excerpt, dir_out=out,
                verbosity_print='WARNING', device=d, **kw)
            wall = time.perf_counter() - t0
            counts = read_counts()
            reason = result.coordinator.end_reason
            with open(os.path.join(out, 'buzzdetect_manifest.json')) as f:
                manifest = json.load(f)
            logs = [p for p in os.listdir(out) if p.endswith('.log')]
            text = ''.join(open(os.path.join(out, p)).read() for p in logs)
            note = [ln.strip() for ln in text.splitlines()
                    if "profile 'field'" in ln]
            clf = result.model.classifier
            print(f'(a) {label} on {d}: end reason {reason!r}, {wall:.2f} s '
                  f'wall; manifest profile '
                  f'{manifest.get("profile", "(absent)")!r}; wire '
                  f'{result.model.transfer_dtype!r}; conv precision '
                  f'{clf.conv_precision!r}; field note in the log: '
                  f'{note[0][:90] + "..." if note else "none"}; kernel '
                  f'launches {counts}', flush=True)
            if reason != 'completed':
                fail(f'{label} on {d} ended {reason!r}')
            if manifest.get('profile') != key or (
                    key is None and 'profile' in manifest):
                fail(f'{label} on {d}: the manifest records profile '
                     f'{manifest.get("profile")!r}, expected {key!r}')
            if result.model.transfer_dtype != wire:
                fail(f'{label} on {d}: wire {result.model.transfer_dtype!r}, '
                     f'expected {wire!r}')
            if bool(note) != (key == 'field') or (
                    note and 'mu-law' not in text):
                fail(f'{label} on {d}: the field note in the log is '
                     f'{note!r}')
            if clf.conv_precision != 'highest':
                fail(f'{label} on {d}: conv precision '
                     f'{clf.conv_precision!r}, expected exact f32')
            if d == device:
                warmups = result.coordinator.analyzers_total
                want = dict.fromkeys(('fused_front', 'fused_tail',
                                      'log_mel'), chunks + warmups)
                launched = {k: v for k, v in counts.items() if v}
                if launched != want:
                    fail(f'{label}: the conv kernels launched {launched}, '
                         f'expected {want} ({chunks} chunks and {warmups} '
                         f'warmup)')
        worst = csv_gap(*outs, [name])
        identical = file_bytes(outs[0], name) == file_bytes(outs[1], name)
        print(f'(a) {label}: {device} against CPU max |d| = {worst:.3g} '
              f'after 2-digit rounding (byte-identical: {identical})',
              flush=True)
        if worst > 0.0101:
            fail(f'{label}: {device} and CPU CSVs differ by {worst:.3g}')


def score_tool(dir_embeddings, modelname, out, device):
    """``python -m buzzdetect_torch.tools.score_embeddings`` as a started
    child process (its output to a file beside ``out``)."""
    log = open(out + '.log', 'w')
    return subprocess.Popen(
        [sys.executable, '-m', 'buzzdetect_torch.tools.score_embeddings',
         '--dir_embeddings', dir_embeddings, '--modelname', modelname,
         '--dir_out', out, '--device', device],
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT), log


def wait_children(children, what):
    """Wait for each (label, process, log file); stop any that outlives
    PHASE11_TIMEOUT; fail on a non-zero exit, showing its output."""
    try:
        for label, proc, log in children:
            try:
                rc = proc.wait(timeout=PHASE11_TIMEOUT)
            except subprocess.TimeoutExpired:
                fail(f'{what} {label}: no exit in {PHASE11_TIMEOUT} s')
            log.close()
            if rc != 0:
                with open(log.name) as f:
                    fail(f'{what} {label} exited {rc}: {f.read()[-2000:]}')
    finally:
        for _label, proc, log in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()


def ensemble_columns(path, members, classes):
    """Each member's columns of an ensemble CSV, in ``classes`` order, as a
    table with the start column first (an analyze() CSV's layout)."""
    with open(path) as f:
        lines = f.read().splitlines()
    header = lines[0].split(',')
    table = np.array([ln.split(',') for ln in lines[1:]], float)
    return {m: table[:, [0] + [header.index(f'activation_{m}.{c}')
                               for c in classes]] for m in members}


def embeddings_phase(tmp, excerpt, name, reset_counts, read_counts,
                     device='cuda'):
    """(b) ``embed_directory`` of ``excerpt`` at EMBED_CHUNKS on ``device``
    and on the CPU (start grid, launches per chunk, embeddings against the
    CPU's within EMB_RTOL of the largest), then ``score_embeddings`` on the
    ``device`` embeddings of each chunk length with model_general_v3, and
    on the default ones with the ENSEMBLE bundle that ``tools/
    build_ensemble`` makes: every CSV, and every member's columns of the
    ensemble's, equal to ``analyze()``'s on ``device`` after 2-digit
    rounding. Embeddings made at another chunk length than ``analyze()``'s
    differ from its run at the last frame of each of their chunks, in the
    JAX package as here: that frame's patch reads 15 ms past its 0.96 s,
    zero padding at a chunk's end and audio inside ``analyze()``'s chunk.
    Those rows are reported apart and every other row is held. The
    children are stopped before this returns. Returns the conv launches of
    each chunk length's ``device`` run by batch (``read_batches``)."""
    import buzzdetect_torch
    from buzzdetect_torch import config as cfg
    from buzzdetect_torch.tools import build_ensemble
    from buzzdetect_torch.train.embed_corpus import (embed_directory,
                                                     load_embeddings)
    from buzzdetect_torch.write.coverage import gaps_to_chunklist
    print('11b. embed_directory, then score_embeddings', flush=True)
    golden = os.path.join(tmp, 'out_excerpt_default')
    result = buzzdetect_torch.analyze(modelname=MODEL, dir_audio=excerpt,
                                      dir_out=golden, device=device,
                                      verbosity_print='WARNING')
    if result.coordinator.end_reason != 'completed':
        fail(f'analyze() of the excerpt ended '
             f'{result.coordinator.end_reason!r}')
    classes = list(result.model.config['classes'])
    dirs, batches = {}, {}
    for cl in EMBED_CHUNKS:
        got = {}
        for role, d in (('run', device), ('cpu', 'cpu')):
            out = os.path.join(tmp, f'emb_{cl:g}_{role}')
            reset_counts()
            t0 = time.perf_counter()
            written = embed_directory(excerpt, out, modelname=MODEL,
                                      chunklength=cl, log=lambda *_: None,
                                      device=d)
            wall = time.perf_counter() - t0
            counts = read_counts()
            if role == 'run':
                batches[cl] = read_batches()
            if len(written) != 1:
                fail(f'embed_directory at {cl:g} s on {d} wrote {written}')
            got[role] = load_embeddings(written[0])
            dirs[cl, role] = out
            if role == 'cpu':
                continue
            rounded = max(round(cl / 0.96) * 0.96, 0.96)
            chunks = len(gaps_to_chunklist([(0.0, EXCERPT_SECONDS)],
                                           rounded))
            starts = got[role][0]
            steps = np.diff(starts)
            print(f'(b) embed_directory at chunklength {cl:g} s ({rounded:g} '
                  f's chunks) on {d}: {wall:.2f} s wall, {len(starts)} '
                  f'frames, starts {starts[:3].tolist()} ... '
                  f'{starts[-2:].tolist()}, stride {steps.min():.6f}-'
                  f'{steps.max():.6f} s over {chunks} chunks; kernel '
                  f'launches {counts}', flush=True)
            if starts[0] != 0.0 or not np.allclose(steps, 0.96, atol=1e-6):
                fail(f'the start grid at {cl:g} s is off the 0.96 s stride')
            want = dict.fromkeys(('fused_front', 'fused_tail', 'log_mel'),
                                 chunks)
            launched = {k: v for k, v in counts.items() if v}
            if launched != want:
                fail(f'embed_directory at {cl:g} s launched {launched}, '
                     f'expected {want}')
        (s_dev, e_dev), (s_cpu, e_cpu) = got['run'], got['cpu']
        scale = float(np.abs(e_cpu).max())
        diff = float(np.abs(e_dev - e_cpu).max())
        print(f'(b) embeddings at {cl:g} s, {device} against CPU: shape '
              f'{e_dev.shape}, max |d| = {diff:.3g} (budget '
              f'{EMB_RTOL} x {scale:.3g})', flush=True)
        if (e_dev.shape != e_cpu.shape or not np.array_equal(s_dev, s_cpu)
                or diff > EMB_RTOL * scale):
            fail(f'embeddings at {cl:g} s: {device} and CPU differ by '
                 f'{diff:.3g}')

    models = cfg.resolve_dir(cfg.DIR_MODELS)
    src = os.path.join(ROOT, 'models', MODEL)
    for member in ENSEMBLE[:2]:
        dst = os.path.join(models, member)
        shutil.copytree(src, dst, ignore=shutil.ignore_patterns('model.npz'))
        os.symlink(os.path.join(src, 'model.npz'),
                   os.path.join(dst, 'model.npz'))
    build_ensemble.main([os.path.join(models, m) for m in ENSEMBLE[:2]]
                        + ['--out', os.path.join(models, ENSEMBLE[2])])
    runs = [(f'{MODEL}, {cl:g} s embeddings', dirs[cl, 'run'], MODEL,
             os.path.join(tmp, f'scored_{cl:g}')) for cl in EMBED_CHUNKS]
    runs.append((f'{ENSEMBLE[2]} (ensemble), {EMBED_CHUNKS[0]:g} s '
                 f'embeddings', dirs[EMBED_CHUNKS[0], 'run'], ENSEMBLE[2],
                 os.path.join(tmp, 'scored_ensemble')))
    t0 = time.perf_counter()
    children = [(label,) + score_tool(emb, model, out, device)
                for label, emb, model, out in runs]
    wait_children(children, 'score_embeddings')
    print(f'(b) {len(children)} score_embeddings processes, run together: '
          f'{time.perf_counter() - t0:.2f} s wall', flush=True)
    with open(os.path.join(golden, f'{name}_buzzdetect.csv')) as f:
        want = np.array([ln.split(',') for ln in f.read().splitlines()[1:]],
                        float)
    for cl, (label, _emb, model, out) in zip(EMBED_CHUNKS, runs):
        with open(os.path.join(out, f'{name}_buzzdetect.csv')) as f:
            table = np.array([ln.split(',') for ln in
                              f.read().splitlines()[1:]], float)
        if table.shape != want.shape:
            fail(f'score_embeddings with {label}: shape {table.shape}, '
                 f'analyze() {want.shape}')
        gap = np.abs(table - want).max(axis=1)
        per_chunk = round(max(round(cl / 0.96) * 0.96, 0.96) / 0.96)
        edge = np.zeros(len(gap), bool)
        if abs(per_chunk * 0.96 - result.chunklength) > 1e-6:
            edge[per_chunk - 1::per_chunk] = True
            edge[-1] = True
        identical = file_bytes(out, name) == file_bytes(golden, name)
        print(f'(b) score_embeddings with {label}: against analyze() on '
              f'{device} max |d| = {gap[~edge].max():.3g} after 2-digit '
              f'rounding over {int((~edge).sum())} rows'
              + (f', {gap[edge].max():.3g} over the {int(edge.sum())} rows '
                 f'that end a {per_chunk * 0.96:g} s chunk' if edge.any()
                 else '') + f' (byte-identical: {identical})', flush=True)
        if gap[~edge].max() > 0.0101:
            fail(f'score_embeddings with {label} differs from analyze() by '
                 f'{gap[~edge].max():.3g}')
    label, _emb, _model, out = runs[-1]
    members = ensemble_columns(os.path.join(out, f'{name}_buzzdetect.csv'),
                               ENSEMBLE[:2], classes)
    worst = max(float(np.abs(t - want).max()) if t.shape == want.shape
                else np.inf for t in members.values())
    print(f'(b) score_embeddings with {label}: each member\'s {len(classes)} '
          f'columns against analyze() on {device} max |d| = {worst:.3g} '
          f'after 2-digit rounding', flush=True)
    if worst > 0.0101:
        fail(f'the ensemble\'s member columns differ from analyze() by '
             f'{worst:.3g}')
    return batches


def console_script_phase(tmp, dir_audio, dir_out, name, device='cuda'):
    """(c) The installed script's form, ``sys.exit(main(argv))``, in a
    child process on phase 3's recording ``name``: exit status 0, no
    Analyzer on stderr, the CSV byte-identical to phase 3's in
    ``dir_out``. The child is stopped before this returns."""
    print('11c. the installed CLI\'s exit status', flush=True)
    one = os.path.join(tmp, 'console_audio')
    os.makedirs(one)
    os.symlink(os.path.join(dir_audio, f'{name}.wav'),
               os.path.join(one, f'{name}.wav'))
    out = os.path.join(tmp, 'out_console')
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, '-c', CONSOLE_SCRIPT, '--modelname', MODEL,
             '--dir_audio', one, '--dir_out', out, '--verbosity_print',
             'WARNING', '--device', device],
            cwd=ROOT, capture_output=True, text=True,
            timeout=PHASE11_TIMEOUT)
    except subprocess.TimeoutExpired:
        fail(f'the CLI child gave no exit in {PHASE11_TIMEOUT} s')
    print(f'(c) sys.exit(buzzdetect_torch.cli.main([...])) in a child on '
          f'{device}: exit status {proc.returncode}, '
          f'{time.perf_counter() - t0:.2f} s wall; stderr names the '
          f'Analyzer: {"Analyzer" in proc.stderr}', flush=True)
    if proc.returncode != 0 or 'Analyzer' in proc.stderr:
        fail(f'the CLI child exited {proc.returncode}: '
             f'{proc.stderr[-2000:]}')
    same_csvs(out, dir_out, [name], 'the CLI child')


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
    from buzzdetect_torch.models import yamnet
    from buzzdetect_torch.models.classifier import _classify, _to_float
    from buzzdetect_torch.models.heads import apply_head
    from buzzdetect_torch.models.weights import params_from_numpy
    from buzzdetect_torch.ops import _build, frontend, logmel, probe, sepconv
    from buzzdetect_torch.ops import layer1 as layer1_lib
    from buzzdetect_torch.ops.common import exact_f32, load_libraries
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
    load_libraries(_build.SOURCES)
    print(f'built and loaded {", ".join(SOURCES.values())} in '
          f'{time.perf_counter() - t0:.1f} s (one nvcc per source, in '
          f'parallel)', flush=True)
    native = decoder_line()

    # --- 2. kernels against their plain versions -----------------------
    card = geometry_phase()
    exact_f32()
    dev = torch.device('cuda')
    with np.load(os.path.join(ROOT, 'models', MODEL, 'model.npz')) as z:
        arrays = {k: z[k] for k in z.files}
    all_params = params_from_numpy(arrays, dev)
    cfg = frontend.FrontendConfig().with_framehop(1.0)
    rows, outputs = {}, {}
    # CUDA events less device time, per call: the host's launch work
    host_ms = {}
    sms, per_sm = logmel._card(dev, logmel.load_kernels())
    print(f'log_mel: blocks an SM runs at once per tile FT: {per_sm} on '
          f'{sms} SMs', flush=True)

    def check_row(name, b, got, ref, again, run_kernel, run_plain,
                  run_library, work, mode, product=None):
        """Hold one kernel call against its plain version, time the three,
        give the kernel's and the library call's device time alone, print
        the row; keep it at B=209. A conv row also gives the unit that runs
        its layers' product ('mma' or 'ffma')."""
        err = float((got - ref).abs().max())
        atol, rtol = tolerance(mode, ref)
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
            flops, n_bytes = logmel_work(n_frames, w.shape[0], 4)
            log_mel_geometry(logmel, dev, b, n_frames)
            got = logmel.log_mel_spectrogram_fused(w, cfg)
            torch.cuda.synchronize()
            check_row('log_mel', b, got,
                      logmel.log_mel_spectrogram_fused_plain(w, cfg),
                      logmel.log_mel_spectrogram_fused(w, cfg),
                      lambda: logmel.log_mel_spectrogram_fused(w, cfg),
                      lambda: logmel.log_mel_spectrogram_fused_plain(w, cfg),
                      lambda: frontend.log_mel_spectrogram(w, cfg),
                      (flops / f32_peak, n_bytes / bytes_peak, flops,
                       n_bytes), 'highest')
            log_mel_dft_bound(b, n_frames, rows.get('log_mel')
                              if b == BATCHES[0] else None, f32_peak)
        log_mel_chunk_phase(torch, dev, cfg, f32_peak, bytes_peak, time_ms,
                            device_ms)
        layer1_rows = layer1_phase(torch, dev, all_params['yamnet'], cfg,
                                   bytes_peak, time_ms, device_ms)
        rows.update(layer1_rows)

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
                              mode,
                              sepconv.layer_route(mode))

        # each mode's device time layer by layer, at B = 209, each layer on
        # its input from the plain stack, with its bound; in exact f32 also
        # the cuDNN layer's (TF32 off), to show where the FFMA kernel loses,
        # and the same at B = 1 and 8 (the narrow tiles)
        layer_ms = {}
        for mode, b in [(m, b0) for m in sepconv.MODES] + [
                ('highest', b) for b in LAYER_BATCHES]:
            params = sepconv.pack_params(all_params['yamnet'], mode)
            x = yamnet.layer1(params, patches[:b].contiguous(), mode)
            parts, vs_library = [], []
            for s in sepconv.tail_specs(2, None):
                layer = dict(start_layer=s.index, stop_layer=s.index + 1,
                             gap=False, mode=mode)
                pw_f, dw_f, n_bytes = stack_work((s,), b, False, mode)
                t_ops = ((pw_f + dw_f) / f32_peak if mode == 'highest'
                         else max(pw_f / bf16_peak, dw_f / f32_peak))
                t_bound = max(t_ops, n_bytes / bytes_peak)
                ms = device_ms(lambda: sepconv.fused_tail(params, x, **layer))
                layer_ms[mode, s.index, b] = ms
                geo = ''
                if mode == 'highest':
                    g = sepconv.ffma_geometry(s, b, card)
                    geo = f' {g.kernel} {g.bn}x{g.bm}'
                # the yardstick beside layers 8-12 and 14 (stride 1, so as
                # many positions in as out): probe.cu's dot_f32, the same
                # exact-f32 FFMA product without the depthwise, on the
                # layer's input and pointwise weight (not counted)
                dot = ''
                if mode == 'highest' and b == b0 and s.index in DOT_LAYERS:
                    a = x.reshape(-1, s.c_in).contiguous()
                    w = params[f'{s.name}/pointwise_conv/kernel']
                    dot_ms = device_ms(
                        lambda: probe.launch_dot('dot_f32', a, w))
                    dot = (f', dot_f32 {a.shape[0]}x{s.c_in}x{s.c_out} '
                           f'{dot_ms:.4f}: layer / dot_f32 '
                           f'{ms / dot_ms:.2f}x')
                parts.append(f'{s.index}{geo}: {ms:.4f} (bound '
                             f'{1e3 * t_bound:.4f}, '
                             f'{ms / (1e3 * t_bound):.1f}x{dot})')
                if mode == 'highest':
                    lib_w = library_weights(params, (s,), torch.float32)
                    x_nchw = x.permute(0, 3, 1, 2).contiguous()
                    lib_ms = device_ms(lambda: library_stack(
                        lib_w, x_nchw, (s,), False))
                    vs_library.append(f'{s.index}: {lib_ms:.4f} '
                                      f'({ms / lib_ms:.2f}x)')
                x = sepconv.fused_tail_plain(params, x, **layer).reshape(
                    b, s.h_out, s.w_out, s.c_out)
            print(f'device time per layer, ms, [{mode}] B={b}: '
                  + ', '.join(parts), flush=True)
            if vs_library:
                print(f'cuDNN f32 device time per layer, ms (FFMA kernel / '
                      f'cuDNN) B={b}: ' + ', '.join(vs_library), flush=True)
        for mode in ('bf16', 'high'):
            ratios = (f'{i}: {layer_ms[mode, i, b0] / ms:.2f}x'
                      for (m, i, b), ms in layer_ms.items()
                      if m == 'highest' and b == b0)
            print(f'[{mode}] tensor cores / exact-f32 FFMA kernel, per layer: '
                  + ', '.join(ratios), flush=True)
        mma_tile_phase(all_params['yamnet'], bytes_peak)

        # where one chunk's device time goes, stage by stage, at B = 209,
        # with the matmul frontend and with the fused log-mel
        params = all_params['yamnet']
        l1 = yamnet.layer1(params, patches)
        mid = outputs['fused_front'].reshape(b0, 6, 4, 512)
        wire = torch.from_numpy(quantize_int16(wav.astype(np.float32))).to(dev)
        stages = {
            'frontend': lambda: frontend.log_mel_patches(_to_float(wire), cfg),
            'fused log-mel frontend (int16 wire)':
                lambda: frontend.patches_from_log_mel(
                    logmel.log_mel_spectrogram_fused(wire, cfg), cfg),
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
        frontend_span_phase(torch, all_params, wire, cfg)
        ast_rows = ast_phase(torch, dev, f32_peak, bf16_peak, bytes_peak,
                             time_ms, device_ms)
        rows.update(ast_rows)

    # --- 3. the main paths end to end ----------------------------------
    def reset_counts():
        sepconv.fused_front.launches = dict.fromkeys(sepconv.LAUNCH_KEYS, 0)
        sepconv.fused_tail.launches = dict.fromkeys(sepconv.LAUNCH_KEYS, 0)
        sepconv.fused_front.ranges.clear()
        sepconv.fused_tail.ranges.clear()
        sepconv.fused_front.batches.clear()
        sepconv.fused_tail.batches.clear()
        logmel.log_mel_spectrogram_fused.launches = 0
        layer1_lib.layer1.launches = 0

    def read_counts():
        """The launches of the wrappers in each mode; the layers run on
        the wide tensor-core tile are read apart (``wide_layers``)."""
        counts = {'log_mel': logmel.log_mel_spectrogram_fused.launches}
        for fn in (sepconv.fused_front, sepconv.fused_tail):
            for mode in sepconv.MODES:
                counts[fn.__name__ + ('' if mode == 'highest'
                                      else f'[{mode}]')] = fn.launches[mode]
        return counts

    def wide_layers():
        return sum(fn.launches['mma_wide']
                   for fn in (sepconv.fused_front, sepconv.fused_tail))

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
    batches = read_batches()
    print(f'analyze: end reason {analyzer.coordinator.end_reason!r}, '
          f'{wall:.2f} s wall, kernel launches {counts}', flush=True)
    if analyzer.coordinator.end_reason != 'completed':
        fail(f'analyze ended {analyzer.coordinator.end_reason!r}')
    for name in ('fused_front', 'fused_tail'):
        if counts[name] <= 0:
            fail(f'the main path never launched {name}')
        launches[name] = counts[name]
    # frontend 'auto' is the fused log-mel on the card: one launch a chunk
    if counts['log_mel'] != counts['fused_front']:
        fail(f'the main path launched log_mel {counts["log_mel"]} times for '
             f'{counts["fused_front"]} chunks')
    launches['log_mel'] = counts['log_mel']
    # layer 1 is one kernel launch an embed
    if layer1_lib.layer1.launches != counts['fused_front']:
        fail(f'the main path launched layer 1 {layer1_lib.layer1.launches} '
             f'times for {counts["fused_front"]} chunks')
    launches['layer1'] = layer1_lib.layer1.launches
    check_csvs(dir_out, names, seconds, analyzer.chunklength, cfg)
    check_chunk_on_cpu(analyzer, arrays, os.path.join(dir_audio, 'rec0.wav'),
                       os.path.join(dir_out, 'rec0_buzzdetect.csv'),
                       'highest')
    def stack_ms(wrapper, b, params=all_params['yamnet'], l1=l1, mid=mid):
        """Device ms of one exact-f32 launch of ``wrapper`` at B = b, on
        phase 2's activations."""
        with torch.inference_mode():
            if wrapper == 'fused_front':
                x = l1[:b].contiguous()
                return device_ms(lambda: sepconv.fused_front(params, x))
            x = mid[:b].contiguous()
            return device_ms(lambda: sepconv.fused_tail(params, x))
    batch_share_phase('3. analyze()', batches, stack_ms)

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
        result = cli_run(argv)
        wall = time.perf_counter() - t0
        counts = read_counts()
        reason = result.coordinator.end_reason
        print(f'CLI {" ".join(argv[:2] + flags)} ({key}): end reason '
              f'{reason!r}, {wall:.2f} s wall, kernel launches {counts}, '
              f'layers on the wide tensor-core tile {wide_layers()}',
              flush=True)
        if reason != 'completed':
            fail(f'the CLI run of {variant} ended {reason!r}')
        # every variant's frontend is the fused log-mel on the card
        want = [f'fused_front[{mode}]', f'fused_tail[{mode}]', 'log_mel']
        for name in want:
            if counts[name] <= 0:
                fail(f'the CLI run of {variant} never launched {name}')
        launches.update((k, counts[k]) for k in want[:2])
        if layer1_lib.layer1.launches != counts[want[0]]:
            fail(f'the CLI run of {variant} launched layer 1 '
                 f'{layer1_lib.layer1.launches} times for '
                 f'{counts[want[0]]} chunks')
        launches[f'layer1[{mode}]' if mode == 'bf16' else 'layer1'] = \
            layer1_lib.layer1.launches
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

    # (f) the int8 probe
    int8_phase(reset_counts, read_counts)

    # --- 5. native rates: on-device resampling and the decode stage ----
    resampler_phase(torch, dev, f32_peak, bytes_peak, time_ms, device_ms)
    native_rate_phase(tmp, arrays, cfg, native, reset_counts, read_counts)

    # --- 6. the XLA conv path and the layouts without a collective -----
    xla_rows = xla_conv_phase(torch, dev, arrays, cfg, wire,
                              os.path.join(dir_audio, 'rec0.wav'),
                              analyzer.chunklength, classify_ms, reset_counts,
                              read_counts, time_ms, device_ms)
    xla_cli_phase(tmp, arrays, cfg, cli_audio, cli_names, cli_seconds,
                  reset_counts, read_counts)
    replica_phase(tmp, dir_audio, dir_out, names, reset_counts, read_counts)
    host_shard_phase(tmp, dir_audio, dir_out, names)
    mesh_phase(tmp, arrays, cfg, dir_audio, dir_out, names,
               BATCHES[0] * 0.96, reset_counts, read_counts, time_ms,
               device_ms)

    # --- 7. training and writers ---------------------------------------
    training_phase(tmp, time_ms, device_ms, f32_peak, reset_counts,
                   read_counts)

    # --- 8. the serving export, the GUI and the operators' dispatch ----
    print('8. the serving export, the GUI child and the custom operators\' '
          'dispatch', flush=True)
    export_rows = export_phase(
        torch, tmp, os.path.join(dir_audio, 'rec0.wav'), BATCHES[0] * 0.96,
        {'xla': xla_rows['high']['xla_classify'], 'pallas': classify_ms,
         'pallas, "frontend": "pallas"': pallas_ms},
        reset_counts, read_counts, time_ms)
    gui_phase(tmp, dir_audio, dir_out, names)
    with torch.inference_mode():
        dispatch_phase(torch, all_params['yamnet'], l1[:5].contiguous(),
                       mid[:5].contiguous(), rows)
    examples_phase()

    # --- 10. the JAX package's kernel and pipeline suites -------------
    with torch.inference_mode():
        suite_kernel_phase(torch, all_params, patches, wav_dev, cfg,
                           device_ms, (f32_peak, bf16_peak, bytes_peak))
    excerpt = pipeline_modes_phase(tmp, dir_audio, dir_out, names, seconds,
                                   analyzer.chunklength, reset_counts,
                                   read_counts)
    fresh_artifact_phase(tmp, export_rows['pallas'])

    # --- 11. the last JAX suites' paths --------------------------------
    t0 = time.perf_counter()
    profile_phase(tmp, excerpt, names[0], analyzer.chunklength, reset_counts,
                  read_counts)
    embed_batches = embeddings_phase(tmp, excerpt, names[0], reset_counts,
                                     read_counts)
    batch_share_phase(f'11b. embed_directory at {EMBED_CHUNKS[1]:g} s',
                      embed_batches[EMBED_CHUNKS[1]], stack_ms)
    console_script_phase(tmp, dir_audio, dir_out, names[0])
    print(f'phase 11: {time.perf_counter() - t0:.2f} s wall', flush=True)

    # --- 9. the kernels line ------------------------------------------
    print(f'torch.profiler sessions that recorded no device time on any '
          f'attempt, timed by CUDA events instead: {device_ms.fallbacks}',
          flush=True)
    order = ('layer1', 'layer1[bf16]', 'fused_front', 'fused_tail',
             'fused_front[bf16]',
             'fused_tail[bf16]', 'fused_front[high]', 'fused_tail[high]',
             'log_mel', 'log_mel[kaldi]', 'attention', 'bias_epilogue',
             'remap') + DOTS + (
                 'fma_chain',)
    launches.update((k, ast_rows[k]['launches']) for k in ast_rows)
    table = []
    for name in order:
        r = rows[name]
        base = name.split('[')[0]
        source = SOURCES['layer1' if base == 'layer1' else
                         'logmel' if base == 'log_mel' else
                         'attention' if base == 'attention' else
                         'epilogue' if base == 'bias_epilogue' else
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
