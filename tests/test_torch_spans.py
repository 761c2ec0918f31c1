"""The port's spans (``buzzdetect_torch/runtime/spans.py``) and the
benchmark's readers of them (``benchmark/spans.py``, the ``frontend_roofline``,
``launch.host_ms.stream`` and ``wire.host_ms.stream`` readers), on the CPU.

* with no profiler session a span is one shared null context and
  ``record_function`` is never entered on the dispatch path;
* in a session started on the main thread, a dispatch, copy back and wait
  on a second thread record every span, nested as documented, the three
  sharing one chunk id (a guard on ``torch.autograd._profiler_enabled()``,
  False on such a thread, would record none);
* the readers on a hand-built Chrome trace: device time by each launch's
  runtime call on its own thread, host time counted once, chunks outside
  ``bench.active`` left out; a trace without the spans reads None;
* a traced rehearsal of each cell (``benchmark/run.py --rehearse``, in a
  subprocess): the host readers are positive and the span-counted chunks
  equal the closed loop's ``trace_chunks``.
"""

import json
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from benchmark import spans as bench_spans
from benchmark.manifest import Benchmark
from buzzdetect_torch.models.classifier import ChunkClassifier
from buzzdetect_torch.models.convert import build_model_bundle
from buzzdetect_torch.runtime import spans
from buzzdetect_torch.runtime.inferer import _start_host_copy
from buzzdetect_torch.runtime.writer import _materialize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ('dispatch', 'wire', 'upload', 'classify', 'frontend', 'embed',
         'head', 'copy_back', 'wait')


@pytest.fixture(scope='module')
def classifier(tmp_path_factory):
    d = tmp_path_factory.mktemp('models') / 'spanmodel'
    build_model_bundle(str(d), classes=['a', 'ins_buzz'], seed=5)
    with np.load(os.path.join(d, 'model.npz')) as z:
        arrays = {k: z[k] for k in z.files}
    return ChunkClassifier(arrays, device='cpu', transfer_dtype='int16')


def _chunk(seconds=1.5, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(16000 * seconds)) * 3000).astype(np.int16)


def _one_chunk(clf, samples):
    out, n_valid = clf.predict_async(samples)
    return _materialize(_start_host_copy(out), n_valid)


def _session():
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile
    return profile(activities=[ProfilerActivity.CPU],
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))


def test_no_session_enters_no_record_function(classifier, monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError('record_function entered with no session')
    monkeypatch.setattr(torch.autograd.profiler, 'record_function', refuse)
    monkeypatch.setattr(spans, '_RecordFunctionFast', refuse)
    assert spans.span('buzzdetect.dispatch') is spans.NULL
    assert spans.span('buzzdetect.wait') is spans.NULL
    spans.mark(3)
    spans.mark([4, 5])
    scores = _one_chunk(classifier, _chunk())
    assert scores.shape == (2, 2)
    out, _ = classifier.predict_async_batch([_chunk(), _chunk(seed=1)])
    assert len(spans.chunk_of(out)) == 2


def _on_thread(tid, events):
    return sorted((e for e in events if e['tid'] == tid),
                  key=lambda e: (e['ts'], -e['dur']))


def _within(inner, outer):
    return (outer['ts'] <= inner['ts'] and inner['ts'] + inner['dur']
            <= outer['ts'] + outer['dur'])


def test_spans_nest_on_a_dispatch_thread(classifier, tmp_path):
    _one_chunk(classifier, _chunk())            # first-use allocations
    prof = _session()
    prof.start()
    flags = {}

    def dispatch_thread():
        flags['tid'] = threading.get_native_id()
        _one_chunk(classifier, _chunk())
        _one_chunk(classifier, _chunk(seed=1))
    try:
        with torch.autograd.profiler.record_function('bench.active'):
            t = threading.Thread(target=dispatch_thread)
            t.start()
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        prof.stop()
    path = str(tmp_path / 'trace.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)['traceEvents']
                  if e.get('cat') in ('user_annotation', 'cpu_op')
                  and e['name'].startswith('buzzdetect.')]
    mine = _on_thread(flags['tid'], events)
    assert {e['name'] for e in mine} >= {f'buzzdetect.{n}' for n in NAMES}
    assert all(e['tid'] == flags['tid'] for e in events)
    by = {n: [e for e in mine if e['name'] == f'buzzdetect.{n}']
          for n in NAMES}
    assert all(len(v) == 2 for v in by.values()), \
        {n: len(v) for n, v in by.items()}
    markers = [e for e in mine if e['name'].startswith(spans.CHUNK)]
    assert {e['cat'] for e in mine if e not in markers} == {'user_annotation'}
    ids = []
    for k in range(2):
        d = by['dispatch'][k]
        for n in ('wire', 'upload', 'classify'):
            assert _within(by[n][k], d), n
        for n in ('frontend', 'embed', 'head'):
            assert _within(by[n][k], by['classify'][k]), n
        for n in ('copy_back', 'wait'):
            assert not _within(by[n][k], d)
            assert by[n][k]['ts'] >= d['ts'] + d['dur'], n
        found = []
        for n in ('dispatch', 'copy_back', 'wait'):
            inside = [m for m in markers if _within(m, by[n][k])]
            assert len(inside) == 1, n
            found.append(inside[0]['name'])
        assert len(set(found)) == 1
        ids.append(int(found[0][len(spans.CHUNK):]))
    assert ids[1] == ids[0] + 1
    # the id is never in a span's name; a marker has nothing inside it
    assert all(re.fullmatch(r'buzzdetect\.[a-z_]+', e['name'])
               for e in mine if e not in markers)
    # the benchmark reads the same session in memory, as the export has it
    inmem = bench_spans.Spans(bench_spans.chrome_events(prof))
    exported = bench_spans.Spans(json.load(open(path))['traceEvents'])
    assert inmem.chunks == exported.chunks == 2
    for names in (('buzzdetect.classify',),
                  ('buzzdetect.wire', 'buzzdetect.upload')):
        assert inmem.host_s(names) == pytest.approx(exported.host_s(names),
                                                    rel=1e-6, abs=1e-9)


def _x(cat, name, tid, ts, dur, corr=None):
    e = {'ph': 'X', 'cat': cat, 'name': name, 'tid': tid, 'ts': ts,
         'dur': dur, 'args': {}}
    if corr is not None:
        e['args']['correlation'] = corr
    return e


def _span(name, tid, ts, dur):
    return _x('user_annotation', f'buzzdetect.{name}', tid, ts, dur)


def _hand_trace():
    """Two dispatch threads (10, 11) on streams 7 and 8 whose kernels
    interleave in time; chunk A starts before ``bench.active``, chunk D
    after it; a runtime call on thread 12 lies, in time, inside thread 10's
    frontend span."""
    ev = [_x('user_annotation', 'bench.active', 1, 100, 900)]
    # chunk A, thread 10, before the window
    ev += [_span('dispatch', 10, 50, 100), _span('classify', 10, 55, 85),
           _span('frontend', 10, 60, 40),
           _x('cuda_runtime', 'cudaLaunchKernel', 10, 70, 2, 1)]
    # chunk B, thread 10
    ev += [_span('dispatch', 10, 200, 200), _span('wire', 10, 201, 9),
           _span('upload', 10, 210, 5), _span('classify', 10, 215, 175),
           _span('frontend', 10, 216, 84), _span('embed', 10, 300, 80),
           _x('cuda_runtime', 'cudaLaunchKernel', 10, 220, 2, 3),
           _x('cuda_runtime', 'cudaLaunchKernel', 10, 250, 2, 4),
           _x('cuda_runtime', 'cudaLaunchKernel', 10, 310, 2, 5)]
    # chunk C, thread 11: its wire and upload spans overlap by 1 us
    ev += [_span('dispatch', 11, 205, 215), _span('wire', 11, 206, 7),
           _span('upload', 11, 212, 8), _span('classify', 11, 220, 190),
           _span('frontend', 11, 221, 99),
           _x('cuda_runtime', 'cudaMemcpyAsync', 11, 230, 2, 6),
           _x('cuda_runtime', 'cudaLaunchKernel', 11, 318, 1, 7),
           _x('cuda_runtime', 'cudaLaunchKernel', 11, 330, 2, 8)]
    # chunk D, thread 11, after the window
    ev += [_span('dispatch', 11, 1100, 100), _span('frontend', 11, 1105, 50),
           _x('cuda_runtime', 'cudaLaunchKernel', 11, 1110, 2, 9)]
    # another thread's call, inside thread 10's frontend span in time
    ev += [_x('cuda_runtime', 'cudaLaunchKernel', 12, 250, 2, 11)]
    # the device: streams 7 and 8 interleave
    ev += [_x('kernel', 'k1', 7, 80, 1000, 1),
           _x('kernel', 'gemm', 7, 300, 40, 3),
           _x('kernel', 'add', 7, 350, 30, 4),
           _x('kernel', 'conv', 7, 380, 100, 5),
           _x('gpu_memcpy', 'Memcpy DtoD', 8, 320, 50, 6),
           _x('kernel', 'gemm', 8, 345, 20, 7),
           _x('kernel', 'conv', 8, 370, 200, 8),
           _x('kernel', 'gemm', 8, 1120, 700, 9),
           _x('kernel', 'gemm', 9, 260, 999, 11),
           _x('kernel', 'stray', 9, 400, 555, 99),
           _x('gpu_user_annotation', 'buzzdetect.frontend', 7, 300, 90)]
    return ev


class _Run:
    """What a reader sees of a traced run on the card."""

    def __init__(self, events, chunk_samples):
        self.tracer = object()
        self.spans = bench_spans.Spans(events)
        self.outcome = {'chunk_samples': chunk_samples, 'trace_chunks': 2}
        self.config = {'transfer_dtype': 'int16'}
        self.card = 'NVIDIA H100 80GB HBM3'


def test_spans_attribute_device_time_by_launch():
    s = bench_spans.Spans(_hand_trace())
    assert s.chunks == 2
    # B's launches 3, 4 and C's 6, 7; not A's 1 nor D's 9 (outside the
    # window), not 5 or 8 (embed, classify), not 11 (another thread), not
    # 99 (no runtime call)
    assert s.device_s('buzzdetect.frontend') == pytest.approx(140e-6)
    assert s.device_s('buzzdetect.embed') == pytest.approx(100e-6)
    assert s.device_s('buzzdetect.classify') == pytest.approx(440e-6)
    assert [x[1] for x in s.spans('buzzdetect.frontend')] == [216, 221]


def test_host_readers_count_each_stretch_once():
    s = bench_spans.Spans(_hand_trace())
    # classify whole (children not subtracted): B 175 + C 190 us
    assert s.host_s(('buzzdetect.classify',)) == pytest.approx(365e-6)
    # wire and upload: B 9 + 5; C 7 + 8 less their 1 us overlap
    assert s.host_s(('buzzdetect.wire', 'buzzdetect.upload')) == \
        pytest.approx(28e-6)
    bench = Benchmark(ROOT)
    run = _Run(_hand_trace(), 16000 * 30)
    for suffix in ('', '.bf16'):
        launch = bench.reader('launch.host_ms.stream' + suffix)(run)
        wire = bench.reader('wire.host_ms.stream' + suffix)(run)
        assert launch == pytest.approx(365e-3 / 2)
        assert wire == pytest.approx(28e-3 / 2)


def test_frontend_roofline_reads_the_correlated_kernels():
    from benchmark import roofline
    bench = Benchmark(ROOT)
    n = 16000 * 1600
    run = _Run(_hand_trace(), n)
    peak = roofline.PEAKS['H100 SXM']
    b = roofline.patches(n)
    bound = max(roofline.frontend_flops(n) / peak['f32'],
                (2 * n + 4 * b * 96 * 64) / peak['bytes'])
    for name in ('frontend_roofline', 'frontend_roofline.bf16'):
        assert bench.reader(name)(run) == pytest.approx(
            100.0 * 2 * bound / 140e-6)


def test_readers_read_none_without_the_spans():
    """A program without spans (the parent's) gives no chunk and no value;
    nor does an untraced run."""
    bare = [e for e in _hand_trace() if not e['name'].startswith('buzzdetect')]
    bench = Benchmark(ROOT)
    run = _Run(bare, 16000 * 30)
    assert run.spans.chunks == 0
    untraced = _Run(bare, 16000 * 30)
    untraced.tracer, untraced.spans = None, None
    for name in ('frontend_roofline', 'launch.host_ms.stream',
                 'wire.host_ms.stream'):
        assert bench.reader(name)(run) is None
        assert bench.reader(name)(untraced) is None


REHEARSE = r'''
import json, sys
sys.path.insert(0, {root!r})
from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile
# Kineto's first start in a process takes seconds on a CPU, longer than the
# rehearsal's lead and window together; a process that traced once before
# starts in about a millisecond
warm = profile(activities=[ProfilerActivity.CPU],
               experimental_config=_ExperimentalConfig(
                   profile_all_threads=True))
warm.start()
warm.stop()
from benchmark import run, spans
read_metrics = run.read_metrics

def counted(r, metrics, required):
    out = read_metrics(r, metrics, required)
    s = spans.of(r)
    print('COUNTS ' + json.dumps({{'spans': s.chunks,
                                   'loop': r.outcome.get('trace_chunks')}}))
    return out

run.read_metrics = counted
sys.exit(run.main(['--workload', {cell!r}, '--seed', '2718281828',
                   '--seconds', '4', '--trace', '1', '--rehearse']))
'''


@pytest.mark.parametrize('cell,suffix', [('f32.long_chunks.pinned', ''),
                                         ('bf16.long_chunks.pinned', '.bf16')])
def test_traced_rehearsal_counts_the_loop_chunks(cell, suffix):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    proc = subprocess.run(
        [sys.executable, '-c', REHEARSE.format(root=ROOT, cell=cell)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    counts = json.loads([ln for ln in lines
                         if ln.startswith('COUNTS ')][-1][len('COUNTS '):])
    result = json.loads([ln for ln in lines if ln.startswith(
        'rehearsal: ')][-1][len('rehearsal: '):])
    assert result['correct']
    assert counts['spans'] == counts['loop'] > 0
    numbers = result['host_numbers']
    assert numbers['launch.host_ms.stream' + suffix]['value'] > 0
    assert numbers['wire.host_ms.stream' + suffix]['value'] > 0
    assert 'frontend_roofline' + suffix not in numbers


# --- the Audio Spectrogram Transformer ---------------------------------------------

def _ast_spied(monkeypatch):
    """The tiny AST model on the CPU with its two operators' routes forced
    to the card's and the operators replaced by spies that open a
    ``spy.<op>`` range, compute the plain version and count a launch, as
    the CUDA implementations count theirs."""
    from buzzdetect_torch.models.registry import load_model
    from buzzdetect_torch.ops import attention, library, logmel, sepconv

    def spy_log_mel(x, constants, window, hop, floor, geometry='yamnet',
                    shift=0.0, scale=1.0):
        assert geometry == 'kaldi'
        with torch.autograd.profiler.record_function('spy.log_mel'):
            out = logmel.log_mel_spectrogram_fused_plain(
                x, logmel.KaldiFbankConfig())
        sepconv._count_launch(logmel.log_mel_spectrogram_fused)
        return out

    def spy_attention(qkv, heads, scale):
        with torch.autograd.profiler.record_function('spy.attention'):
            out = attention.attention_plain(qkv, heads, scale)
        sepconv._count_launch(attention.attention)
        return out
    monkeypatch.setattr(logmel, '_route', lambda x: 'cuda')
    monkeypatch.setattr(attention, '_route', lambda x: 'cuda')
    monkeypatch.setattr(library, 'log_mel', spy_log_mel)
    monkeypatch.setattr(library, 'attention', spy_attention)
    return load_model('ast_tiny', device='cpu', compute_dtype='bfloat16',
                      initialize=True)


@pytest.mark.parametrize('block', [128, 2])
def test_ast_spans_hold_their_launches(monkeypatch, tmp_path, block):
    """Each attention launch lies inside a ``buzzdetect.attention`` span
    inside ``buzzdetect.embed``, the fbank's one launch inside
    ``buzzdetect.frontend``; a block of windows launches one attention a
    block of the encoder (12 at the published depth, 2 here), and
    ``patch_embed``, ``embed`` and ``head`` once each, inside
    ``classify``."""
    from buzzdetect_torch.models import ast
    from buzzdetect_torch.ops import attention, logmel
    model = _ast_spied(monkeypatch)
    monkeypatch.setattr(ast, 'WINDOW_BLOCK', block)
    samples = _chunk(seconds=6.3)          # 5 windows of 1.28 s
    model.predict(samples)                 # first-use allocations
    blocks = -(-5 // block)
    before = (logmel.log_mel_spectrogram_fused.launches,
              attention.attention.launches)
    prof = _session()
    prof.start()
    try:
        _one_chunk(model.classifier, samples)
    finally:
        prof.stop()
    launched = (logmel.log_mel_spectrogram_fused.launches - before[0],
                attention.attention.launches - before[1])
    depth = model.ast_config.depth
    assert launched == (1, depth * blocks)
    assert ast.ASTConfig().depth == 12
    path = str(tmp_path / 'trace.json')
    prof.export_chrome_trace(path)
    events = [e for e in json.load(open(path))['traceEvents']
              if e.get('cat') == 'user_annotation']
    by = {}
    for e in events:
        by.setdefault(e['name'], []).append(e)
    assert len(by['spy.log_mel']) == 1
    assert len(by['spy.attention']) == depth * blocks
    assert len(by['buzzdetect.attention']) == depth * blocks
    for name in ('patch_embed', 'embed', 'head'):
        assert len(by[f'buzzdetect.{name}']) == blocks
        assert all(_within(e, by['buzzdetect.classify'][0])
                   for e in by[f'buzzdetect.{name}'])
    assert _within(by['spy.log_mel'][0], by['buzzdetect.frontend'][0])
    for e in by['spy.attention']:
        assert any(_within(e, s) for s in by['buzzdetect.attention'])
    for s in by['buzzdetect.attention']:
        assert any(_within(s, emb) for emb in by['buzzdetect.embed'])


def _ast_trace():
    """One AST chunk in the window on thread 10: its fbank kernel launched
    in the frontend span, two attention kernels in attention spans, a GEMM
    in the embed span outside them."""
    ev = [_x('user_annotation', 'bench.active', 1, 100, 900)]
    ev += [_span('dispatch', 10, 200, 600), _span('classify', 10, 210, 580),
           _span('frontend', 10, 220, 40), _span('embed', 10, 300, 400),
           _span('attention', 10, 320, 50), _span('attention', 10, 500, 50),
           _x('cuda_runtime', 'cudaLaunchKernel', 10, 230, 2, 1),
           _x('cuda_runtime', 'cudaLaunchKernel', 10, 310, 2, 2),
           _x('cuda_runtime', 'cudaLaunchKernel', 10, 330, 2, 3),
           _x('cuda_runtime', 'cudaLaunchKernel', 10, 510, 2, 4)]
    ev += [_x('kernel', 'logmel_fft_kernel', 7, 240, 30, 1),
           _x('kernel', 'gemm', 7, 320, 500, 2),
           _x('kernel', 'attention_bf16_kernel', 7, 820, 70, 3),
           _x('kernel', 'attention_bf16_kernel', 7, 890, 80, 4)]
    return ev


def test_ast_readers_read_the_correlated_kernels():
    from benchmark import roofline, roofline_ast
    bench = Benchmark(ROOT)
    config = json.load(open(os.path.join(
        ROOT, 'benchmark', 'configs',
        'ast_audioset_10s.bf16.long_chunks.json')))
    n = 20_971_760
    run = _Run(_ast_trace(), n)
    run.config = config
    peak = roofline.peaks(run.card)
    want_attention = roofline_ast.attention_bound_s(
        128, config['sizes'], peak) / 150e-6
    want_fbank = roofline_ast.fbank_bound_s(n, config, peak) / 30e-6
    assert bench.reader('attention_roofline', 'ast')(run) == pytest.approx(
        100.0 * want_attention)
    assert bench.reader('frontend_roofline.ast', 'ast')(run) == \
        pytest.approx(100.0 * want_fbank)
    bare = [e for e in _ast_trace()
            if not e['name'].startswith('buzzdetect')]
    for name in ('attention_roofline', 'frontend_roofline.ast'):
        assert bench.reader(name, 'ast')(_Run(bare, n)) is None
        with pytest.raises(ValueError, match='counts the work of ast'):
            bench.reader(name, 'yamnet')


def test_traced_ast_rehearsal_counts_the_loop_chunks():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    proc = subprocess.run(
        [sys.executable, '-c', REHEARSE.format(
            root=ROOT, cell='ast.bf16.long_chunks.pinned')],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    counts = json.loads([ln for ln in lines
                         if ln.startswith('COUNTS ')][-1][len('COUNTS '):])
    result = json.loads([ln for ln in lines if ln.startswith(
        'rehearsal: ')][-1][len('rehearsal: '):])
    assert result['correct']
    assert counts['spans'] == counts['loop'] > 0
    # the cell's layer metrics read the card's trace: none on the CPU
    assert result['host_numbers'] == {}
