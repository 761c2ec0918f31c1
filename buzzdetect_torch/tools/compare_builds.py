"""Are this checkout's kernels bit for bit another build's?

Builds a second ``csrc/sepconv.cu`` and/or ``csrc/probe.cu`` (for example a
parent commit's, unpacked beside this checkout) with the same ``nvcc``
flags, loads it next to this checkout's library, and runs the same work
through both on the card. Every pair must be equal (``torch.equal``):
resume is byte-identical only if a redesigned kernel keeps its arithmetic.

``--against sepconv.cu``: ``fused_front`` (layers 2-7), ``fused_tail``
(layers 8-14 + pooling) and layers 4-7 in exact f32, and the fronts and
tails in bf16 and HIGH, at B = 209 (one 200 s chunk) and at the small
batches 1, 2, 3, 5 and 8 (ragged last chunks, short chunk lengths), on
seeded inputs with the bundle's weights. Then it times, at each of those
B, the three stacks in every mode they run in and each exact-f32 layer
2-14 alone through both libraries, in turns (other, this, this, other;
device time alone, ``utils.cuda_device_ms``, the better of each pair
kept), so that a layer
the redesign made slower shows on the same card in the same run. With
``--launches`` (a run's conv launches by batch, as ``chip_smoke.py``
prints them; repeatable) it also gives each batch's share of that run's
conv device time through each library (``conv_shares``). With
``--analyze SECONDS`` it runs ``analyze()`` on three seeded recordings of
that length through each library twice, in turns (``ops/sepconv.load_kernels``
swapped for the other's during its runs), prints each run's realtime
factor and compares the CSVs byte for byte, then
resumes through this library from a partial holding the other run's
second chunk of the first recording, against the other's whole CSV.

``--against-probe probe.cu``: the three products (``dot_f32``,
``dot_high``, ``dot_high_emulated``) at the probe's shape (1024 x 128 x
128, its seeded operands) and the conv tail's two pointwise shapes (5016 x
512 x 512 with layer 8's weight, 1254 x 1024 x 1024 with layer 14's,
seeded activations), and the 20 layout cases: the other build's
``bz_probe_remap`` one case at a time against this build's
``bz_probe_remap_batch`` over all 20. Then it times each product at each
shape and the 20 layout cases through both libraries in the same turns,
by CUDA events and by device time alone (``torch.profiler``).

``--against-logmel logmel.cu``: the fused log-mel at B = 209 and B = 5
(20,064 and 480 frames of one seeded waveform) and on a batch of two
seeded waveforms whose length is no whole number of hops (1,001 frames
each), then the same three timed through both libraries in the same
turns, by CUDA events and by device time. A build of the dense-DFT
design (``bz_logmel_clusters``) takes other operands and is refused
(``logmel.bind``).

    python -m buzzdetect_torch.tools.compare_builds \\
        [--against OTHER_CHECKOUT/buzzdetect_torch/csrc/sepconv.cu] \\
        [--against-probe OTHER_CHECKOUT/buzzdetect_torch/csrc/probe.cu] \\
        [--against-logmel OTHER_CHECKOUT/buzzdetect_torch/csrc/logmel.cu] \\
        [--launches '{"fused_front": {"209": 27}, "fused_tail": {...}}'] \\
        [--analyze 1800]

One line per case and per timed item; exit code 0 only when every case
is equal.
"""

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from buzzdetect_torch.ops import _build, logmel, probe, sepconv
from buzzdetect_torch.ops.common import exact_f32

# name -> (layers, gap, modes)
CASES = {'fused_front': (dict(start_layer=2, stop_layer=8), False,
                         sepconv.MODES),
         'fused_tail': (dict(start_layer=8, stop_layer=None), True,
                        sepconv.MODES),
         'fused_tail[4:8]': (dict(start_layer=4, stop_layer=8), False,
                             ('highest',))}
BATCHES = (209, 1, 2, 3, 5, 8)
# the product kernels' cases: label -> (M, K, N, the bundle's pointwise
# weight or None for the probe's own seeded one)
DOT_SHAPES = {'probe': (1024, 128, 128, None),
              'layers 8-12': (5016, 512, 512, 'layer8'),
              'layer 14': (1254, 1024, 1024, 'layer14')}
PRODUCTS = ('dot_f32', 'dot_high', 'dot_high_emulated')
# the fused log-mel's cases: label -> (batch, frames per waveform)
LOGMEL_CASES = {'B=209': (1, 20064), 'B=5': (1, 480),
                'ragged batch of 2': (2, 1001)}


def build_other(path, bind=sepconv.bind):
    """Compile ``path`` (another copy of a ``csrc/*.cu``, its headers beside
    it) into ``csrc/build/`` and load it, bound by ``bind`` (``sepconv.bind``,
    ``probe.bind`` or ``logmel.bind``) as this checkout's library is."""
    digest = hashlib.sha256(' '.join(_build.NVCC_FLAGS).encode())
    folder = os.path.dirname(os.path.abspath(path))
    for f in [path] + sorted(os.path.join(folder, h) for h in
                             os.listdir(folder) if h.endswith('.cuh')):
        with open(f, 'rb') as fh:
            digest.update(fh.read())
    out = os.path.join(_build.DIR_BUILD,
                       f'libother_{digest.hexdigest()[:16]}.so')
    if not os.path.exists(out):
        os.makedirs(_build.DIR_BUILD, exist_ok=True)
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, '-o', out,
                               path], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed on {path}:\n{proc.stdout}'
                               f'{proc.stderr}')
    return bind(ctypes.CDLL(out))


def inputs(params, mode, device, seed=0):
    """Seeded log-mel-like patches through layer 1, and the plain front's
    outputs entering layers 4 and 8, at the largest batch."""
    from buzzdetect_torch.models import yamnet
    gen = torch.Generator(device=device).manual_seed(seed)
    patches = torch.randn((BATCHES[0], 96, 64, 1), device=device,
                          generator=gen)
    l1 = yamnet.layer1(params, patches, mode)
    b = BATCHES[0]
    return {'fused_front': l1,
            'fused_tail': sepconv.fused_front_plain(params, l1, mode=mode)
            .reshape(b, 6, 4, 512),
            'fused_tail[4:8]': sepconv.fused_front_plain(
                params, l1, start_layer=2, stop_layer=4, mode=mode)
            .reshape(b, 24, 16, 128)}


def compare(other, device):
    """{(case, mode, batch): equal} over every case, this checkout's
    library against ``other``."""
    yam = _weights(device)
    exact_f32()
    results = {}
    with torch.inference_mode():
        for mode in sepconv.MODES:
            params = sepconv.pack_params(yam, mode)
            xs = inputs(params, mode, device)
            for name, (layers, gap, modes) in CASES.items():
                if mode not in modes:
                    continue
                specs = sepconv.tail_specs(layers['start_layer'],
                                           layers['stop_layer'])
                for b in BATCHES:
                    x = xs[name][:b].contiguous()
                    ops = sepconv._check(params, x, specs, mode)
                    ours = sepconv._launch(ops, x, specs, gap, mode)
                    theirs = sepconv._launch(ops, x, specs, gap, mode,
                                             lib=other)
                    torch.cuda.synchronize(device)
                    results[name, mode, b] = _report(
                        f'{name} [{mode}] B={b} {tuple(ours.shape)}', ours,
                        theirs)
    return results


def _report(label, ours, theirs):
    """Print whether ``ours`` equals ``theirs`` bit for bit; return it."""
    same = torch.equal(ours, theirs)
    d = float((ours - theirs).abs().max())
    print(f'{label}: {"bit-identical" if same else "DIFFERENT"} (max |d| '
          f'{d:.3g})', flush=True)
    return same


def time_layers(other, device):
    """{(layer, B): (this ms, other ms)} of every exact-f32 layer alone at
    each of BATCHES, device time, each on its input from the plain
    stack."""
    from buzzdetect_torch.utils import cuda_device_ms
    params = sepconv.pack_params(_weights(device), 'highest')
    card = sepconv.library_card()
    times = {}
    with torch.inference_mode():
        l1 = inputs(params, 'highest', device)['fused_front']
        for b in BATCHES:
            x = l1[:b].contiguous()
            for s in sepconv.tail_specs(2, None):
                ops = sepconv._check(params, x, (s,), 'highest')
                ours, theirs = _in_turns(
                    lambda lib: sepconv._launch(ops, x, (s,), False,
                                                'highest', lib=lib), other,
                    cuda_device_ms)
                times[s.index, b] = ours, theirs
                g = sepconv.ffma_geometry(s, b, card)
                print(f'layer {s.index} (C={s.c_in}, F={s.c_out}, B={b}; '
                      f'this: {g.kernel} {g.bn}x{g.bm}, {g.blocks} blocks): '
                      f'device time this {ours:.4f} ms, other {theirs:.4f} '
                      f'ms (this / other {ours / theirs:.2f}x)', flush=True)
                x = sepconv.fused_tail_plain(
                    params, x, start_layer=s.index, stop_layer=s.index + 1,
                    gap=False).reshape(b, s.h_out, s.w_out, s.c_out)
    return times


def time_stacks(other, device, batches=BATCHES, names=tuple(CASES),
                modes=('highest',)):
    """{(case, B): (this ms, other ms)}: device time of ``names`` of CASES
    (fused_front, fused_tail, fused_tail[4:8]) at each of ``batches``, in
    turns, in exact f32; in each other mode of ``modes`` the case runs in
    too, keyed (case, mode, B)."""
    from buzzdetect_torch.utils import cuda_device_ms
    yam = _weights(device)
    times = {}
    with torch.inference_mode():
        for mode in modes:
            params = sepconv.pack_params(yam, mode)
            xs = inputs(params, mode, device)
            for name in names:
                layers, gap, case_modes = CASES[name]
                if mode not in case_modes:
                    continue
                specs = sepconv.tail_specs(layers['start_layer'],
                                           layers['stop_layer'])
                for b in batches:
                    x = xs[name][:b].contiguous()
                    ops = sepconv._check(params, x, specs, mode)
                    ours, theirs = _in_turns(
                        lambda lib: sepconv._launch(ops, x, specs, gap,
                                                    mode, lib=lib), other,
                        cuda_device_ms)
                    key = (name, b) if mode == 'highest' else (name, mode, b)
                    times[key] = ours, theirs
                    print(f'{name} [{mode}] B={b}: device time this '
                          f'{ours:.4f} ms, other {theirs:.4f} ms (this / '
                          f'other {ours / theirs:.2f}x)', flush=True)
    return times


def conv_shares(hist, times):
    """{wrapper: {B: share}}: each wrapper's launches at each B, times its
    device ms per launch there, over the run's conv device time (every
    launch of both wrappers). ``hist`` is {wrapper: {B: launches}} and
    ``times`` {wrapper: {B: ms}}."""
    total = sum(n * times[w][b] for w, h in hist.items() for b, n in h.items())
    return {w: {b: n * times[w][b] / total for b, n in h.items()}
            for w, h in hist.items()}


def launch_shares(other, device, hist):
    """A run's conv launches by batch (``hist``: {wrapper: {B: n}}, the
    wrappers' default ranges, exact f32) priced through both libraries:
    prints each B's share of the run's conv device time, this and other."""
    stacks = time_stacks(other, device, sorted({b for h in hist.values()
                                                for b in h}), tuple(hist))
    for i, which in enumerate(('this', 'other')):
        times = {w: {b: stacks[w, b][i] for b in h} for w, h in hist.items()}
        shares = conv_shares(hist, times)
        print(f'launches {hist}, priced by {which} library: share of the '
              f'conv device time ' + '; '.join(
                  f'{w} ' + ', '.join(f'B={b} {v:.4f}' for b, v in sh.items())
                  for w, sh in shares.items()), flush=True)


def _in_turns(run, other, timer=None):
    """(this ms, other ms): ``run(lib)`` timed through ``other``, this
    checkout's library (lib None) twice, then ``other`` again, by ``timer``
    (default: the median of 15 CUDA-event timings); the better of each
    pair."""
    from buzzdetect_torch.utils import cuda_time_ms
    timer = timer or cuda_time_ms
    t = [timer(lambda lib=lib: run(lib)) for lib in (other, None, None,
                                                      other)]
    return min(t[1:3]), min(t[0], t[3])


def dot_operands(device):
    """{label: (a, w)} of ``DOT_SHAPES``: the probe's seeded operands, and
    seeded standard-normal activations with the bundle's pointwise weights
    at the tail's shapes."""
    from buzzdetect_torch.tools.capability_probe import dot_inputs
    yam = _weights(device)
    gen = torch.Generator(device=device).manual_seed(0)
    ops = {}
    for label, (m, k, n, layer) in DOT_SHAPES.items():
        if layer is None:
            flat, w = dot_inputs()
            ops[label] = (torch.from_numpy(flat).to(device),
                          torch.from_numpy(w).to(device))
        else:
            w = yam[f'{layer}/pointwise_conv/kernel'].contiguous()
            ops[label] = (torch.randn((m, k), device=device, generator=gen),
                          w)
    return ops


def remap_one(lib, case, x, w):
    """One layout case through ``lib``'s ``bz_probe_remap``, the one-case
    entry every build of ``csrc/probe.cu`` has."""
    shape = probe._out_shape(case, tuple(x.shape),
                             None if w is None else tuple(w.shape))
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    dims = (ctypes.c_int64 * 8)(*probe._padded(x.shape),
                                *probe._padded(shape))
    probe._call('bz_probe_remap', x.device, probe._CASE_ID[case],
                x.data_ptr(), None if w is None else w.data_ptr(),
                out.data_ptr(), dims, out.numel(), lib=lib)
    return out


def _product_operand(name, w):
    """The weight as product ``name`` takes it."""
    return sepconv.pack_pointwise(w, 'high') if name == 'dot_high_emulated' \
        else w


def compare_probe(other, device):
    """{case: equal}: the three products at ``DOT_SHAPES`` and the 20 layout
    cases, this checkout's library against ``other``."""
    from buzzdetect_torch.tools.capability_probe import layout_items
    exact_f32()
    results = {}
    with torch.inference_mode():
        for label, (a, w) in dot_operands(device).items():
            m, k = a.shape
            for name in PRODUCTS:
                w_op = _product_operand(name, w)
                ours = probe.launch_dot(name, a, w_op)
                theirs = probe.launch_dot(name, a, w_op, lib=other)
                torch.cuda.synchronize(device)
                results[name, label] = _report(
                    f'{name} {label} ({m}x{k} @ {k}x{w.shape[1]})', ours,
                    theirs)
        items = layout_items(device)
        ours = probe.remap_batch(items)
        theirs = [remap_one(other, *item) for item in items]
        torch.cuda.synchronize(device)
        for (case, x, _w), o, t in zip(items, ours, theirs):
            results['remap', case] = _report(
                f'remap {case} {tuple(x.shape)} -> {tuple(o.shape)} (this '
                f'build: one batch of 20; other: one launch each)', o, t)
    return results


def time_probe(other, device):
    """{item: ((this, other) CUDA-event ms, (this, other) device ms)} of
    each product at each shape and of the 20 layout cases (this build: one
    batch; other: one launch per case), in turns."""
    from buzzdetect_torch.tools.capability_probe import layout_items
    with torch.inference_mode():
        runs = {f'{name} {label}':
                lambda lib, name=name, a=a, w=_product_operand(name, w):
                probe.launch_dot(name, a, w, lib=lib)
                for label, (a, w) in dot_operands(device).items()
                for name in PRODUCTS}
        items = layout_items(device)
        runs['remap, 20 layout cases'] = lambda lib: (
            probe.remap_batch(items) if lib is None
            else [remap_one(lib, *item) for item in items])
        return _time_runs(runs, other)


def _time_runs(runs, other):
    """{name: ((this, other) CUDA-event ms, (this, other) device ms)} of
    each ``run(lib)`` in ``runs``, in turns; one line each."""
    from buzzdetect_torch.utils import cuda_device_ms
    times = {}
    for name, run in runs.items():
        events = _in_turns(run, other)
        device_time = _in_turns(run, other, cuda_device_ms)
        times[name] = events, device_time
        print(f'{name}: this {events[0]:.4f} ms, other {events[1]:.4f} '
              f'ms by CUDA events (this / other '
              f'{events[0] / events[1]:.2f}x); device time this '
              f'{device_time[0]:.4f} ms, other {device_time[1]:.4f} ms '
              f'({device_time[0] / device_time[1]:.2f}x)', flush=True)
    return times


def logmel_inputs(device, seed=0):
    """{label: (B, n) waveforms} of ``LOGMEL_CASES``: B = 209 and B = 5 are
    the first 20,064 and 480 frames of one seeded waveform, the ragged
    batch two more seeded waveforms with 97 samples past their last
    frame."""
    gen = torch.Generator(device=device).manual_seed(seed)
    wav = 0.1 * torch.randn(logmel.WINDOW + logmel.HOP * (20064 - 1),
                            device=device, generator=gen)
    out = {}
    for label, (b, frames) in LOGMEL_CASES.items():
        n = logmel.WINDOW + logmel.HOP * (frames - 1)
        if b == 1:
            out[label] = wav[:n].reshape(1, n).contiguous()
        else:
            out[label] = 0.1 * torch.randn((b, n + 97), device=device,
                                           generator=gen)
    return out


def compare_logmel(other, device):
    """{('log_mel', label): equal} over ``LOGMEL_CASES``, this checkout's
    library against ``other``."""
    from buzzdetect_torch.ops.frontend import FrontendConfig
    cfg = FrontendConfig()
    results = {}
    with torch.inference_mode():
        for label, x in logmel_inputs(device).items():
            ours = logmel._launch(x, cfg)
            theirs = logmel._launch(x, cfg, lib=other)
            torch.cuda.synchronize(device)
            results['log_mel', label] = _report(
                f'log_mel {label} {tuple(x.shape)} -> {tuple(ours.shape)}',
                ours, theirs)
    return results


def time_logmel(other, device):
    """{item: ((this, other) CUDA-event ms, (this, other) device ms)} of the
    fused log-mel over ``LOGMEL_CASES``, in turns."""
    from buzzdetect_torch.ops.frontend import FrontendConfig
    cfg = FrontendConfig()
    with torch.inference_mode():
        return _time_runs(
            {f'log_mel {label}':
             lambda lib, x=x: logmel._launch(x, cfg, lib=lib)
             for label, x in logmel_inputs(device).items()}, other)


def write_wav(path, seconds, seed, rate=16000):
    """A seeded 16 kHz PCM16 recording: a harmonic tone that comes and
    goes, over noise."""
    import wave
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    tone = sum(0.15 / k * np.sin(2 * np.pi * (180 + 40 * seed) * k * t)
               for k in (1, 2, 3)) * (np.sin(2 * np.pi * t / 37.0) > 0.3)
    x = tone + 0.02 * rng.standard_normal(len(t))
    with wave.open(path, 'wb') as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.clip(np.round(x * 32768), -32768, 32767)
                      .astype('<i2').tobytes())


def compare_analyze(other, seconds, root):
    """{('analyze' or 'resume', name): equal}: ``analyze()`` of three seeded
    recordings of ``seconds`` under ``root``, through this library and
    through ``other`` in turns (this, other, other, this), each run's
    realtime factor printed, CSVs byte for byte; then a resume through this
    library from a partial holding the other run's second chunk of the
    first recording, against the other's whole CSV."""
    import shutil
    import buzzdetect_torch
    dir_audio = os.path.join(root, 'audio')
    os.makedirs(dir_audio)
    names = [f'rec{i}' for i in range(3)]
    for i, name in enumerate(names):
        write_wav(os.path.join(dir_audio, f'{name}.wav'), seconds, i)
    outs, results, rates = {}, {}, {'this': [], 'other': []}
    # in turns (this, other, other, this), so that a drift of the machine
    # over the call shows in both libraries' realtime factors alike
    for turn, (which, lib) in enumerate((('this', None), ('other', other),
                                         ('other', other), ('this', None))):
        saved = sepconv.load_kernels
        if lib is not None:
            sepconv.load_kernels = lambda lib=lib: lib
        try:
            outs[which, turn] = os.path.join(root, f'out_{which}_{turn}')
            t0 = time.perf_counter()
            run = buzzdetect_torch.analyze(
                modelname='model_general_v3', dir_audio=dir_audio,
                dir_out=outs[which, turn], verbosity_print='WARNING')
            wall = time.perf_counter() - t0
        finally:
            sepconv.load_kernels = saved
        if run.coordinator.end_reason != 'completed':
            raise RuntimeError(f'analyze() through the {which} library '
                               f'ended {run.coordinator.end_reason!r}')
        rates[which].append(run.coordinator.audio_seconds_done / wall)
    outs['this'], outs['other'] = outs['this', 0], outs['other', 1]
    print('analyze() realtime factor (audio s per wall s, model load and '
          'warmup included), in turns this, other, other, this: this '
          + ', '.join(f'{r:.1f}' for r in rates['this']) + '; other '
          + ', '.join(f'{r:.1f}' for r in rates['other']), flush=True)
    chunk_s = run.chunklength

    def csv(folder, name):
        with open(os.path.join(folder, f'{name}_buzzdetect.csv'), 'rb') as f:
            return f.read()
    for name in names:
        got = {csv(folder, name) for key, folder in outs.items()
               if isinstance(key, tuple)}
        results['analyze', name] = same = len(got) == 1
        print(f'analyze() {name} ({seconds:g} s, {chunk_s:g} s chunks): '
              f'CSVs of the four runs '
              f'{"byte-identical" if same else "DIFFERENT"}', flush=True)
    name, resumed = names[0], os.path.join(root, 'out_resume')
    os.makedirs(resumed)
    lines = csv(outs['other'], name).decode().splitlines(keepends=True)
    per_chunk = int(round(chunk_s / 0.96))
    with open(os.path.join(resumed, f'{name}_buzzpart.csv'), 'w') as f:
        f.write(lines[0])
        f.writelines(lines[1 + per_chunk:1 + 2 * per_chunk])
    shutil.copy(os.path.join(outs['other'], 'buzzdetect_manifest.json'),
                resumed)
    audio = os.path.join(root, 'resume_audio')
    os.makedirs(audio)
    os.symlink(os.path.join(dir_audio, f'{name}.wav'),
               os.path.join(audio, f'{name}.wav'))
    buzzdetect_torch.analyze(modelname='model_general_v3', dir_audio=audio,
                             dir_out=resumed, verbosity_print='WARNING')
    results['resume', name] = same = (csv(resumed, name)
                                      == csv(outs['other'], name))
    print(f'resume of {name} through this library from the other\'s '
          f'partial (its second chunk): CSV '
          f'{"byte-identical" if same else "DIFFERENT"} to the other\'s',
          flush=True)
    return results


def _weights(device):
    from buzzdetect_torch.config import DIR_MODELS
    from buzzdetect_torch.models.weights import params_from_numpy
    with np.load(os.path.join(DIR_MODELS, 'model_general_v3',
                              'model.npz')) as z:
        arrays = {k: z[k] for k in z.files}
    return params_from_numpy(arrays, device)['yamnet']


def main(argv=None):
    ap = argparse.ArgumentParser(
        description='Run the conv stacks, the probe\'s products and layout '
                    'cases and/or the fused log-mel through this checkout\'s '
                    'kernels and another build of them, and check that '
                    'their outputs are equal bit for bit.')
    ap.add_argument('--against', help='path of the other sepconv.cu')
    ap.add_argument('--against-probe', help='path of the other probe.cu')
    ap.add_argument('--against-logmel', help='path of the other logmel.cu')
    ap.add_argument('--launches', action='append', default=[],
                    help='a run\'s conv launches by batch, JSON '
                    '{"fused_front": {"B": n}, "fused_tail": {...}}, as '
                    'chip_smoke.py prints it (with --against; repeatable)')
    ap.add_argument('--analyze', type=float, metavar='SECONDS',
                    help='analyze() three seeded recordings of SECONDS '
                    'through both builds and a resume (with --against)')
    args = ap.parse_args(argv)
    if not (args.against or args.against_probe or args.against_logmel):
        ap.error('give one or more of --against, --against-probe and '
                 '--against-logmel')
    from buzzdetect_torch.models.classifier import resolve_device
    device = resolve_device('cuda')
    others = [p for p in (args.against, args.against_probe,
                          args.against_logmel) if p]
    print(f'device: {torch.cuda.get_device_name(device)}; this checkout '
          f'against {", ".join(others)}', flush=True)
    results = {}
    if args.against:
        other = build_other(args.against)
        results.update(compare(other, device))
        if args.analyze:
            import tempfile
            with tempfile.TemporaryDirectory() as root:
                results.update(compare_analyze(other, args.analyze, root))
    if args.against_probe:
        other_probe = build_other(args.against_probe, probe.bind)
        results.update(compare_probe(other_probe, device))
    if args.against_logmel:
        other_logmel = build_other(args.against_logmel, logmel.bind)
        results.update(compare_logmel(other_logmel, device))
    bad = [k for k, same in results.items() if not same]
    print(f'{len(results) - len(bad)} of {len(results)} cases '
          f'bit-identical', flush=True)
    if args.against:
        time_stacks(other, device, modes=sepconv.MODES)
        time_layers(other, device)
        for launches in args.launches:
            launch_shares(other, device, {
                w: {int(b): n for b, n in h.items()}
                for w, h in json.loads(launches).items()})
    if args.against_probe:
        time_probe(other_probe, device)
    if args.against_logmel:
        time_logmel(other_logmel, device)
    return 1 if bad else 0


if __name__ == '__main__':
    sys.exit(main())
