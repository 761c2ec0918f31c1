#!/usr/bin/env python3
"""Smoke test of the PyTorch port (buzzdetect_torch) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each printed before the last line:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the build of the CUDA kernels from ``buzzdetect_torch/csrc``;
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (B = 209 patches, one default 200 s chunk; and B = 5), with
   the weights of ``models/model_general_v3/model.npz``: max |kernel -
   plain|, and the median times of the kernel, the plain version and the
   cuDNN ``F.conv2d`` stack for the same layers, beside the least time the
   card could take (bound); then one chunk's device time stage by stage
   (frontend, layer 1, the two kernels, head, whole classify);
3. ``buzzdetect_torch.analyze()`` end to end on three 30-minute 16 kHz WAV
   recordings with the default chunk length: complete CSVs with the
   expected rows, the kernels' launch counts, one chunk's scores on the card
   against the same chunk on the CPU, the realtime factor, and an upper
   estimate of the device busy share;
4. one JSON line with every kernel's numbers.

The last line is ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero with a message, and without a CUDA device the script exits
non-zero before printing any result.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCHES = (209, 5)       # one default 200 s chunk at framehop 1; a ragged B
ATOL, RTOL = 2e-4, 1e-5  # exact f32 both sides, different summation order
SCORE_ATOL = 1e-3        # the score parity budget (BASELINE.md)
REPLACES = {'fused_front': 'buzzdetect_tpu/ops/pallas_conv.py:448',
            'fused_tail': 'buzzdetect_tpu/ops/pallas_conv.py:529'}
SOURCE = 'buzzdetect_torch/csrc/sepconv.cu'


def fail(msg):
    print(f'chip_smoke FAILED: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


def peaks(name):
    """(f32 FLOP/s outside the tensor cores, memory bytes/s) from NVIDIA's
    data sheets, for the card nvidia-smi names."""
    if 'H100' not in name:
        fail(f'no peak table for {name!r} (this script targets an H100)')
    if 'PCIe' in name:
        return 51.2e12, 2.0e12
    return 67e12, 3.35e12   # H100 SXM


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


def stack_work(specs, b, gap, weights):
    """(FLOPs, compulsory bytes) of a sep-layer stack at batch b: every
    multiply-add counted twice, the input read once, every weight read
    once, the output written once."""
    flops = 0
    for s in specs:
        pos = b * s.h_out * s.w_out
        flops += 2 * pos * s.c_in * (9 + s.c_out)
    s0, sl = specs[0], specs[-1]
    out = b * sl.c_out * (1 if gap else sl.h_out * sl.w_out)
    n_w = sum(t.numel() for t in weights)
    return flops, 4 * (b * s0.h * s0.w * s0.c_in + n_w + out)


def library_weights(params, specs):
    """Per layer (depthwise OIHW, its bias, pointwise OIHW, its bias), in
    the layout cuDNN takes; built once, outside the timed region."""
    return [(params[f'{s.name}/depthwise_conv/kernel'].t().reshape(
                s.c_in, 1, 3, 3).contiguous(),
             params[f'{s.name}/depthwise_conv/bias'],
             params[f'{s.name}/pointwise_conv/kernel'].t().reshape(
                 s.c_out, s.c_in, 1, 1).contiguous(),
             params[f'{s.name}/pointwise_conv/bias']) for s in specs]


def library_stack(weights, x_nchw, specs, gap):
    """The same layers through cuDNN (F.conv2d for both convs, TF32 off):
    the yardstick, timed here only; the port never calls it."""
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


def main():
    import torch
    if not torch.cuda.is_available():
        fail('torch finds no CUDA device')
    if not os.path.isdir(os.path.join(ROOT, 'buzzdetect_torch')):
        fail(f'no buzzdetect_torch package beside {__file__}; run from the '
             f'root of a checkout')
    sys.path.insert(0, ROOT)
    import buzzdetect_torch
    from buzzdetect_torch.models import yamnet
    from buzzdetect_torch.models.classifier import (
        ChunkClassifier, _classify, _to_float)
    from buzzdetect_torch.models.heads import apply_head
    from buzzdetect_torch.models.weights import params_from_numpy
    from buzzdetect_torch.ops import frontend, sepconv
    from buzzdetect_torch.utils import quantize_int16
    from buzzdetect_torch.write.coverage import gaps_to_chunklist

    # --- 1. the card and the build ------------------------------------
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'device 0: {kind}, count {torch.cuda.device_count()}', flush=True)
    flops_peak, bytes_peak = peaks(kind)
    print(f'peaks used for bounds: {flops_peak / 1e12:g} TFLOP/s f32 '
          f'(no tensor cores), {bytes_peak / 1e12:g} TB/s', flush=True)
    t0 = time.perf_counter()
    sepconv.load_kernels()
    print(f'built and loaded {SOURCE} in {time.perf_counter() - t0:.1f} s',
          flush=True)

    # --- 2. kernels against their plain versions -----------------------
    sepconv.exact_f32()
    dev = torch.device('cuda')
    with np.load(os.path.join(ROOT, 'models', 'model_general_v3',
                              'model.npz')) as z:
        arrays = {k: z[k] for k in z.files}
    all_params = params_from_numpy(arrays, dev)
    params = all_params['yamnet']
    cfg = frontend.FrontendConfig().with_framehop(1.0)
    rows, outputs = {}, {}
    cases = (
        ('fused_front', dict(start_layer=2, stop_layer=8), False),
        ('fused_tail', dict(start_layer=8, stop_layer=None), True),
        ('fused_tail[4:8]', dict(start_layer=4, stop_layer=8), False),
    )
    with torch.inference_mode():
        # realistic activations: log-mel patches of one chunk of audio
        # through layer 1 and the plain layers; B = 5 takes the first rows
        b0 = BATCHES[0]
        n = (frontend.min_waveform_samples(cfg)
             + (b0 - 1) * cfg.patch_hop_samples)
        wav = np.random.default_rng(0).standard_normal(n) * 0.1
        patches = frontend.log_mel_patches(
            torch.from_numpy(wav.astype(np.float32)).to(dev), cfg)
        if patches.shape[0] != b0:
            fail(f'expected {b0} patches, framed {patches.shape[0]}')
        l1 = yamnet.layer1(params, patches)
        inputs = {
            'fused_front': l1,
            'fused_tail': sepconv.fused_front_plain(params, l1)
            .reshape(b0, 6, 4, 512),
            'fused_tail[4:8]': sepconv.fused_front_plain(
                params, l1, start_layer=2, stop_layer=4)
            .reshape(b0, 24, 16, 128)}
        for b in BATCHES:
            for name, layers, gap in cases:
                x = inputs[name][:b].contiguous()
                specs = sepconv.tail_specs(layers['start_layer'],
                                           layers['stop_layer'])
                wrapper = (sepconv.fused_front if name == 'fused_front'
                           else sepconv.fused_tail)
                plain = (sepconv.fused_front_plain if name == 'fused_front'
                         else sepconv.fused_tail_plain)
                kw = dict(layers) if name == 'fused_front' else dict(
                    layers, gap=gap)
                got = wrapper(params, x, **kw)
                torch.cuda.synchronize()
                ref = plain(params, x, **kw)
                err = float((got - ref).abs().max())
                ok = torch.allclose(got, ref, atol=ATOL, rtol=RTOL)
                if not torch.equal(got, wrapper(params, x, **kw)):
                    fail(f'{name} B={b}: two launches on the same input '
                         f'differ')
                if b != b0 and not torch.equal(got, outputs[name][:b]):
                    # per-patch results must not depend on the batch
                    fail(f'{name}: B={b} rows differ from the same rows '
                         f'inside B={b0}')
                x_nchw = x.permute(0, 3, 1, 2).contiguous()
                lib_w = library_weights(params, specs)
                weights = [params[f'{s.name}/{k}'] for s in specs for k in (
                    'depthwise_conv/kernel', 'depthwise_conv/bias',
                    'pointwise_conv/kernel', 'pointwise_conv/bias')]
                flops, nbytes = stack_work(specs, b, gap, weights)
                t_ops, t_bytes = flops / flops_peak, nbytes / bytes_peak
                row = dict(
                    max_abs_err=err,
                    ms=time_ms(torch, lambda: wrapper(params, x, **kw)),
                    plain_ms=time_ms(torch, lambda: plain(params, x, **kw)),
                    library_ms=time_ms(torch, lambda: library_stack(
                        lib_w, x_nchw, specs, gap)),
                    bound_ms=1e3 * max(t_ops, t_bytes),
                    bound_by='operations' if t_ops >= t_bytes else 'bytes')
                torch.cuda.synchronize()
                print(f'kernel {name} B={b}: max |kernel - plain| = '
                      f'{err:.3g} (atol {ATOL}, rtol {RTOL}); kernel '
                      f'{row["ms"]:.4f} ms, plain {row["plain_ms"]:.4f} ms, '
                      f'cuDNN {row["library_ms"]:.4f} ms, bound '
                      f'{row["bound_ms"]:.4f} ms ({row["bound_by"]}: '
                      f'{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)',
                      flush=True)
                if not ok:
                    fail(f'{name} B={b} disagrees with its plain version: '
                         f'max |d| {err:.3g}')
                if b == b0:
                    outputs[name] = got
                    rows[name] = row

        # where one chunk's device time goes, stage by stage, at B = 209
        wire = torch.from_numpy(quantize_int16(wav.astype(np.float32))).to(dev)
        emb = outputs['fused_tail']
        stages = {
            'frontend': lambda: frontend.log_mel_patches(_to_float(wire), cfg),
            'layer 1': lambda: yamnet.layer1(params, patches),
            'fused_front': lambda: sepconv.fused_front(params, l1),
            'fused_tail': lambda: sepconv.fused_tail(
                params, inputs['fused_tail']),
            'head': lambda: apply_head(all_params['head'], emb),
        }
        stage_ms = {k: time_ms(torch, fn) for k, fn in stages.items()}
        classify_ms = time_ms(torch, lambda: _classify(all_params, wire, cfg))
        torch.cuda.synchronize()
        print('one chunk on the card (B=209): ' + ', '.join(
            f'{k} {v:.4f} ms' for k, v in stage_ms.items())
            + f'; whole classify {classify_ms:.4f} ms', flush=True)

    # --- 3. the main path end to end ----------------------------------
    with tempfile.TemporaryDirectory(prefix='buzz_smoke_') as tmp:
        dir_audio = os.path.join(tmp, 'audio')
        os.makedirs(dir_audio)
        seconds = 1800.0
        names = [f'rec{i}' for i in range(3)]
        for i, n in enumerate(names):
            write_recording(os.path.join(dir_audio, f'{n}.wav'), seconds, i)
        dir_out = os.path.join(tmp, 'out')
        sepconv.fused_front.launches = 0
        sepconv.fused_tail.launches = 0
        t0 = time.perf_counter()
        analyzer = buzzdetect_torch.analyze(
            modelname='model_general_v3', dir_audio=dir_audio,
            dir_out=dir_out, verbosity_print='WARNING')
        wall = time.perf_counter() - t0
        launches = {'fused_front': sepconv.fused_front.launches,
                    'fused_tail': sepconv.fused_tail.launches}
        print(f'analyze: end reason {analyzer.coordinator.end_reason!r}, '
              f'{wall:.2f} s wall, kernel launches {launches}', flush=True)
        if analyzer.coordinator.end_reason != 'completed':
            fail(f'analyze ended {analyzer.coordinator.end_reason!r}')
        for name, n in launches.items():
            if n <= 0:
                fail(f'the main path never launched {name}')

        chunk_s = analyzer.chunklength
        chunks = gaps_to_chunklist([(0.0, seconds)], chunk_s)
        expected = sum(frontend.num_patches(
            int(c1 * 16000) - int(c0 * 16000), cfg) for c0, c1 in chunks)
        for n in names:
            path = os.path.join(dir_out, f'{n}_buzzdetect.csv')
            if not os.path.exists(path):
                fail(f'no complete CSV for {n}')
            with open(path) as f:
                lines = f.read().splitlines()
            table = np.array([ln.split(',') for ln in lines[1:]], float)
            if table.shape != (expected, 14):
                fail(f'{n}: CSV shape {table.shape}, expected '
                     f'({expected}, 14)')
            if not np.isfinite(table).all():
                fail(f'{n}: non-finite scores')
            if not np.allclose(table[:, 0], np.round(
                    np.arange(expected) * 0.96, 2)):
                fail(f'{n}: time column is not 0, 0.96, 1.92, ...')
        print(f'CSVs: {len(names)} files x {expected} rows x 13 classes, '
              f'all finite; {len(chunks)} chunks of {chunk_s} s per file',
              flush=True)

        # one chunk on the card against the same chunk on the CPU
        from buzzdetect_torch.audio import build_track
        track = build_track(os.path.join(dir_audio, 'rec0.wav'))
        samples = track.read_s16(int(chunk_s * 16000))
        track.close()
        card = analyzer.model.classifier.predict(samples)
        cpu = ChunkClassifier(arrays, device='cpu',
                              transfer_dtype='int16').predict(samples)
        d = float(np.abs(card - cpu).max())
        print(f'one {chunk_s} s chunk, card vs CPU: {card.shape}, max '
              f'|dscore| = {d:.3g} (budget {SCORE_ATOL})', flush=True)
        if card.shape != cpu.shape or d > SCORE_ATOL:
            fail(f'card and CPU scores differ by {d:.3g}')
        with open(os.path.join(dir_out, 'rec0_buzzdetect.csv')) as f:
            first = np.array([ln.split(',') for ln in
                              f.read().splitlines()[1:]], float)
        first = first[:len(card), 1:]
        if np.abs(first - np.round(card, 2)).max() > 0.0101:
            fail('the CSV does not hold the card\'s scores for chunk 1')
        audio_s = analyzer.coordinator.audio_seconds_done
        print(f'realtime factor: {audio_s / wall:.1f} audio s per wall s '
              f'({audio_s:.1f} audio s in {wall:.2f} s, model load and '
              f'warmup included)', flush=True)
        # every dispatch is one chunk of at most 209 patches, so this is
        # an upper estimate of the run's device time, from phase 2's time
        dispatches = launches['fused_front']
        busy = dispatches * classify_ms / 1e3
        print(f'device time at most {busy:.3f} s ({dispatches} dispatches x '
              f'{classify_ms:.4f} ms whole classify) of {wall:.2f} s wall: '
              f'device busy share at most {busy / wall:.3f}', flush=True)

    # --- 4. the kernels line ------------------------------------------
    out = []
    for name in ('fused_front', 'fused_tail'):
        r = rows[name]
        out.append({'name': name, 'route': 'cuda', 'source': SOURCE,
                    'replaces': REPLACES[name],
                    'launches': launches[name],
                    'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
                    'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
                    'bound_by': r['bound_by'],
                    'library_ms': r['library_ms']})
    print(json.dumps({'kernels': out}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
