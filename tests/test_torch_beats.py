"""BEATs on the port (``models/beats.py``, BEATs' geometry of the Kaldi
fbank in ``ops/logmel.py``, ``ops/attention.attention_relpos``,
``ops/epilogue.post_ln``, the registry's ``BEATsModel``, ``models/convert``'s
BEATs branch), on the CPU at tiny sizes (``models/beats_tiny``: patches of
32, width 64, 2 layers, 4 heads of 16, 128 mel bins, 128-frame windows of
64 tokens) on seeded weights, against the plain reference
``benchmark/reference/beats.py`` loaded by its path; and, on a card alone,
the kernels against their plain versions at the benchmark cell's shapes.

Tolerances:

* f32: 2e-6 on logits of about 0.4: the port's products (the patches as
  a matmul, q, k and v stacked, the position convolution as a 1 x K
  conv2d, the head on the tokens' mean) sum in another order than the
  reference's, a few f32 ulps (read: 1.2-1.5e-7);
* bf16: 5e-3, as AST's: an operand within an f32 ulp of a bf16 rounding
  edge rounds the other way when the sums before it ran in another order,
  and the port's position convolution rounds its output to bf16 where the
  reference's does not (read: 7.7e-4); the fp8 control differs from the
  bf16 reference by more than 4 x 5e-3 here;
* the fbank: 2e-4 after BEATs' normalisation (log power / 13.1): the
  port's power comes from a DFT product, the reference's from
  ``torch.fft.rfft``, and the Povey window leaves the lowest bands a
  thousandth of the frame's energy, where both lose digits;
* each fault case moves the f32 scores by more than 10 x the f32
  tolerance (the smallest, a constant gate, by about 7e-5).
"""

import csv
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.manifest import load_module
from buzzdetect_torch.models import beats, transformer
from buzzdetect_torch.models.registry import BEATsModel, load_model
from buzzdetect_torch.ops import attention, epilogue, logmel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, 'models', 'beats_tiny')
FULL = os.path.join(REPO, 'models', 'beats_iter3p_as2m')
REFERENCE = load_module(os.path.join(REPO, 'benchmark', 'reference',
                                     'beats.py'), 'test_beats_reference')
ATOL = {'f32': 2e-6, 'bf16': 5e-3}
DTYPES = {'f32': None, 'bf16': 'bfloat16'}


def _sizes(path=TINY):
    return json.load(open(os.path.join(path, 'config_model.json')))['sizes']


def _chunk(seconds, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(int(16000 * seconds)) * 3000
    x[::7] += 6000 * np.sin(np.arange(len(x[::7])) * 0.05)
    return np.clip(x, -32768, 32767).astype(np.int16)


def _port(precision, samples, framehop=1.0, model='beats_tiny'):
    m = load_model(model, device='cpu', compute_dtype=DTYPES[precision],
                   transfer_dtype='int16', framehop_prop=framehop,
                   initialize=True)
    return m.predict(samples)


def _reference(precision, samples, framehop=1.0, dir_model=TINY):
    s, w = REFERENCE.load_weights(dir_model, 'cpu')
    return REFERENCE.classify(w, s, samples, framehop, precision, block=2)


@pytest.mark.parametrize('precision', ['f32', 'bf16'])
@pytest.mark.parametrize('seconds,framehop', [(3.0, 1.0), (4.1, 0.5)])
def test_port_matches_the_reference(precision, seconds, framehop):
    x = _chunk(seconds, seed=int(seconds * 10))
    got = _port(precision, x, framehop)
    want = _reference(precision, x, framehop)
    assert got.shape == want.shape
    gap = float(np.abs(got - want).max())
    print(f'{precision} framehop {framehop}: max |port - reference| = '
          f'{gap:.3g}')
    assert gap < ATOL[precision]


def test_the_fp8_control_fails_the_bf16_tolerance():
    x = _chunk(3.0, seed=30)
    gap = np.abs(_reference('fp8', x) - _reference('bf16', x)).max()
    assert gap > 4 * ATOL['bf16']


def test_seeded_weights_are_bit_identical_to_the_reference():
    cfg = beats.BEATsConfig.from_sizes(_sizes())
    port = beats.seeded_params(cfg, 11)
    ref = REFERENCE.seeded(_sizes(), 11)
    assert list(port) == list(ref)
    for k in port:
        assert port[k].dtype == ref[k].dtype == np.float32
        assert np.array_equal(port[k], ref[k]), k
    # the published sizes name the same tensors at the same shapes: 90.7M
    sizes = _sizes(FULL)
    shapes = beats.param_shapes(beats.BEATsConfig.from_sizes(sizes))
    assert list(shapes.items()) == REFERENCE.names_and_shapes(sizes)
    assert sum(int(np.prod(s)) for s in shapes.values()) == 90_716_927
    # the recipe's exceptions: a wide bias table and gate, grep_a at 1
    full = beats.seeded_params(beats.BEATsConfig(), 3)
    assert np.std(full[beats.REL_TABLE]) == pytest.approx(1.0, rel=0.05)
    g = full['encoder.layers.5.self_attn.grep_linear.weight']
    assert np.std(g) == pytest.approx(0.5, rel=0.2)
    assert np.std(full['encoder.layers.5.fc1.weight']) == pytest.approx(
        0.02, rel=0.01)
    assert np.all(full['encoder.layers.5.self_attn.grep_a'] == 1)
    assert np.all(full['encoder.layers.5.final_layer_norm.weight'] == 1)
    assert np.all(full['predictor.bias'] == 0)


def test_the_config_refuses_another_variant():
    assert beats.BEATsConfig().alpha == pytest.approx(24 ** 0.25)
    assert beats.BEATsConfig().tokens == 496
    for bad in (dict(deep_norm=False), dict(layer_norm_first=True),
                dict(gru_rel_pos=False), dict(conv_bias=True),
                dict(relative_position_embedding=False)):
        with pytest.raises(ValueError, match='the port runs'):
            beats.BEATsConfig(**bad)
    with pytest.raises(ValueError, match='patches'):
        beats.BEATsConfig(input_tdim=1000)
    with pytest.raises(ValueError, match='unknown BEATs sizes'):
        beats.BEATsConfig.from_sizes({'finetuned_model': True})


# --- the relative position bias and its gate -------------------------------------

def _published_bucket(d, num_buckets=320, max_distance=800):
    """The published bucketing written out in float64."""
    half = num_buckets // 2
    exact = half // 2
    a = abs(d)
    if a < exact:
        inner = a
    else:
        inner = min(half - 1, exact + int(np.log(a / exact)
                                          / np.log(max_distance / exact)
                                          * (half - exact)))
    return half * (d > 0) + inner


@pytest.mark.parametrize('num_buckets,max_distance', [(320, 800),
                                                      (320, 1280), (64, 100)])
def test_buckets_follow_the_published_formula(num_buckets, max_distance):
    """Every |d| < 2,000: the port's table (float32, as the published
    ``_relative_positions_bucket`` computes it) against the formula in
    float64 and against the reference's own transcription."""
    d = torch.arange(-1999, 2000)
    got = beats.relative_buckets(d, num_buckets, max_distance).tolist()
    assert got == [_published_bucket(int(v), num_buckets, max_distance)
                   for v in d]
    n = 300
    ref = REFERENCE.buckets(n, num_buckets, max_distance, 'cpu')
    port = beats.relative_buckets(
        torch.arange(n)[None, :] - torch.arange(n)[:, None], num_buckets,
        max_distance)
    assert torch.equal(ref, port)
    assert min(got) == 0 and max(got) == num_buckets - 1


def test_bias_rows_hold_the_table_by_distance():
    cfg = beats.BEATsConfig.from_sizes(_sizes())
    table = np.random.default_rng(1).standard_normal(
        (cfg.num_buckets, cfg.encoder_attention_heads)).astype(np.float32)
    n = 40
    rows = beats.bias_rows(table, n, cfg)
    assert rows.shape == (cfg.encoder_attention_heads, 2 * n - 1)
    full = attention.relpos_bias(torch.from_numpy(rows), n)
    for i, j in ((0, 0), (3, 39), (39, 3), (17, 18), (20, 2)):
        b = _published_bucket(j - i, cfg.num_buckets, cfg.max_distance)
        assert np.array_equal(full[:, i, j].numpy(), table[b])


def test_folded_gate_matches_grep_linear():
    """sigmoid(G q + c) of the folded gate is the published sigmoid of
    ``grep_linear``'s 8 outputs summed by 4, and the gate a (b grep_a - 1)
    + 2 of them."""
    gen = torch.Generator().manual_seed(8)
    heads, d = 4, 16
    w = torch.randn(8, d, generator=gen) * 0.5
    b = torch.randn(8, generator=gen) * 0.1
    a = 1 + torch.randn(1, heads, 1, 1, generator=gen) * 0.3
    q = torch.randn(2, heads, 7, d, generator=gen)
    gate = torch.from_numpy(beats.fold_gate(w.numpy(), b.numpy(),
                                            a.numpy()))
    got = attention.relpos_gate(q, gate, heads)
    u = torch.sigmoid(F.linear(q, w, b).view(2, heads, 7, 2, 4).sum(-1))
    ga, gb = u.chunk(2, dim=-1)
    want = (ga * (gb * a - 1.0) + 2.0)[..., 0]
    assert got.shape == want.shape == (2, heads, 7)
    assert float((got - want).abs().max()) < 1e-6
    assert float(want.max() - want.min()) > 0.1


def test_attention_relpos_plain_is_biased_softmax_attention():
    gen = torch.Generator().manual_seed(3)
    heads, n, d = 3, 9, 16
    qkv = torch.randn(1, n, 3 * heads * d, generator=gen)
    rel = torch.randn(heads, 2 * n - 1, generator=gen)
    gate = torch.randn(2 * d + 2 + heads, generator=gen)
    got = attention.attention_relpos_plain(qkv, heads, rel, gate)
    q, k, v = qkv.view(1, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    g = attention.relpos_gate(q, gate, heads)
    bias = torch.stack([torch.stack([rel[:, j - i + n - 1]
                                     for j in range(n)], -1)
                        for i in range(n)], 1)
    s = q @ k.transpose(-1, -2) / 4.0 + g[..., None] * bias
    want = (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(1, n, -1)
    assert torch.allclose(got, want, atol=1e-6)
    # without the bias it is the AST attention
    zero = torch.zeros_like(rel)
    assert torch.allclose(
        attention.attention_relpos_plain(qkv, heads, zero, gate),
        attention.attention_plain(qkv, heads), atol=1e-6)


def test_folded_weight_norm_is_g_v_over_its_norm():
    """``fold_weight_norm`` against PyTorch's own weight norm at dim 2 (a
    norm for each tap), on the position convolution's shape."""
    from buzzdetect_torch.models import convert
    gen = torch.Generator().manual_seed(4)
    v = torch.randn(64, 16, 16, generator=gen)
    g = torch.rand(1, 1, 16, generator=gen) + 0.5
    want = torch._weight_norm(v, g, 2)
    got = convert.fold_weight_norm(g.numpy(), v.numpy(), 2)
    assert got.dtype == np.float32
    assert np.abs(got - want.numpy()).max() < 1e-6
    norms = np.sqrt((got.astype(np.float64) ** 2).sum(axis=(0, 1)))
    assert np.allclose(norms, g.numpy().reshape(-1), rtol=1e-5)


# --- the fbank ------------------------------------------------------------------

@pytest.mark.parametrize('dtype', [torch.int16, torch.float32])
def test_povey_fbank_matches_the_reference(dtype):
    """BEATs' geometry on the wire (raw int16 amplitudes) or on f32
    samples in [-1, 1] (scaled by 2^15) against the reference's fbank."""
    x = _chunk(2.0, seed=4)
    wav = torch.from_numpy(x)
    if dtype == torch.float32:
        wav = wav.float() / 32768.0
    got = logmel.log_mel_spectrogram_fused(wav, logmel.BEATS_FBANK)
    want = REFERENCE.fbank(torch.from_numpy(x).float(), 128)
    assert got.shape == want.shape == (1 + (len(x) - 400) // 160, 128)
    gap = float((got - want).abs().max())
    print(f'fbank: max |port - reference| = {gap:.3g}')
    assert gap < 2e-4


def test_beats_tables_hold_the_povey_window():
    half = logmel.fft_tables(symmetric=True, power=0.85)[0]
    n = np.arange(400)
    want = 0.5 * (0.5 - 0.5 * np.cos(2 * np.pi * n / 399)) ** 0.85
    assert np.abs(half - want).max() < 1e-7
    cfg = logmel.BEATS_FBANK
    assert (cfg.window_power, cfg.input_scale) == (0.85, 32768.0)
    assert cfg.divisor == pytest.approx(13.11164)
    assert logmel._check_geometry(cfg) == 'kaldi'
    # AST's geometry keeps its window and its scale
    assert np.array_equal(logmel.fft_tables(symmetric=True)[0],
                          logmel.fft_tables(symmetric=True, power=1.0)[0])
    assert logmel.KaldiFbankConfig().input_scale == 1.0


# --- the post-LN ---------------------------------------------------------------------

@pytest.mark.parametrize('bf16', [True, False])
def test_post_ln_plain_is_deep_norm_post_ln(bf16):
    gen = torch.Generator().manual_seed(6)
    y = torch.randn(5, 128, generator=gen)
    b, w, nb = (torch.randn(128, generator=gen) for _ in range(3))
    x = torch.randn(5, 128, generator=gen)
    want = F.layer_norm(x * 2.2 + (y + b), (128,), w, nb, 1e-5)
    got_x = x.clone()
    h = epilogue.post_ln(y, b, got_x, w, nb, 2.2, 1e-5, bf16)
    assert torch.allclose(got_x, want, atol=1e-6)
    if bf16:
        assert h.dtype == torch.bfloat16 and torch.equal(
            h, want.to(torch.bfloat16))
    else:
        assert h is None


def test_the_new_operators_refuse_the_cpu():
    from buzzdetect_torch.ops import library
    x, y, b = torch.zeros(2, 128), torch.zeros(2, 128), torch.zeros(128)
    before = (dict(epilogue.post_ln.launches),
              dict(attention.attention_relpos.launches))
    with pytest.raises(NotImplementedError, match='CPU'):
        library.post_ln(x, y, b, b, b, None, 1.0, 1e-5)
    with pytest.raises(NotImplementedError, match='CPU'):
        library.attention_relpos(torch.zeros(1, 4, 3 * 64), 1,
                                 torch.zeros(1, 7), torch.zeros(131), 0.125)
    assert (epilogue.post_ln.launches,
            attention.attention_relpos.launches) == before
    assert before[0] .keys() == {'post_ln'}
    assert before[1].keys() == {'attention_relpos'}


# --- faults the comparison must see ---------------------------------------------------

def _pre_ln_block(p, i, x, h, cfg, bf16):
    """A pre-LN block on the same weights: x += attn(LN1(x)), x +=
    ffn(LN2(x))."""
    w, t, c = x.shape
    eps = cfg.layer_norm_eps
    n = F.layer_norm(x, (c,), p[f'{i}.ln1.w'], p[f'{i}.ln1.b'], eps)
    qkv = transformer.linear(n.view(w * t, c), p[f'{i}.qkv.w'],
                             p[f'{i}.qkv.b']).view(w, t, 3 * c)
    a = attention.attention_relpos(qkv, cfg.encoder_attention_heads,
                                   p['rel'], p[f'{i}.gate'])
    x += transformer.linear(a.view(w * t, c), p[f'{i}.out.w'],
                            p[f'{i}.out.b']).view(w, t, c)
    n = F.layer_norm(x, (c,), p[f'{i}.ln2.w'], p[f'{i}.ln2.b'], eps)
    f = F.gelu(transformer.linear(n.view(w * t, c), p[f'{i}.fc1.w'],
                                  p[f'{i}.fc1.b']))
    x += transformer.linear(f, p[f'{i}.fc2.w'], p[f'{i}.fc2.b']).view(
        w, t, c)
    return x


def _constant_gate(monkeypatch, model):
    monkeypatch.setattr(attention, 'relpos_gate', lambda q, gate, heads:
                        torch.full(q.shape[:-1], 1.75))


def _no_bias(monkeypatch, model):
    monkeypatch.setitem(model.classifier.params, 'rel',
                        torch.zeros_like(model.classifier.params['rel']))


def _alpha_one(monkeypatch, model):
    monkeypatch.setattr(beats.BEATsConfig, 'alpha', property(lambda s: 1.0))


def _pre_ln(monkeypatch, model):
    monkeypatch.setattr(beats, 'block', _pre_ln_block)


def _hann_window(monkeypatch, model):
    monkeypatch.setattr(model.classifier, 'fbank', dataclasses.replace(
        model.classifier.fbank, window_power=1.0))


@pytest.mark.parametrize('fault', [_constant_gate, _no_bias, _alpha_one,
                                   _pre_ln, _hann_window],
                         ids=['constant_gate', 'no_bias', 'alpha_1',
                              'pre_ln', 'hann_window'])
def test_each_fault_leaves_the_tolerance(monkeypatch, fault):
    """The port as it is lies within the f32 tolerance of the reference;
    with any one of BEATs' mechanisms taken out or swapped, more than ten
    times the tolerance away."""
    x = _chunk(3.0, seed=31)
    want = _reference('f32', x)
    model = load_model('beats_tiny', device='cpu', transfer_dtype='int16',
                       initialize=True)
    assert np.abs(model.predict(x) - want).max() < ATOL['f32']
    fault(monkeypatch, model)
    gap = float(np.abs(model.predict(x) - want).max())
    print(f'{fault.__name__}: max |port - reference| = {gap:.3g}')
    assert gap > 10 * ATOL['f32']


# --- windows, the registry, analyze() --------------------------------------------

@pytest.mark.parametrize('n,framehop,windows,padded', [
    (20_316_400, 1.0, 128, 20_316_400),     # the benchmark's chunk
    (158_960, 1.0, 1, 158_960),             # one window exactly
    (158_961, 1.0, 2, 317_680),             # one sample more
    (100, 1.0, 1, 158_960),                 # shorter than a window
    (16000 * 30, 0.5, 6, 158_960 + 5 * 79_360)])
def test_window_counts_and_padding(n, framehop, windows, padded):
    m = load_model('beats_iter3p_as2m', device='cpu', framehop_prop=framehop)
    clf = beats.BEATsClassifier.__new__(beats.BEATsClassifier)
    clf.cfg, clf.fbank = m.model_config, logmel.BEATS_FBANK
    clf.hop_frames = transformer.window_hop_frames(m.model_config, framehop)
    assert (clf._valid(n), clf._padded(n)) == (windows, padded)
    assert REFERENCE.n_windows(n, 992, clf.hop_frames) == windows
    assert m.embedder.framehop_s == pytest.approx(9.92 * framehop)
    from benchmark import roofline_ast
    assert roofline_ast.windows(n, _sizes(FULL), framehop) == windows


def test_the_model_directory_and_its_options():
    m = load_model('beats_iter3p_as2m', device='cpu')
    assert isinstance(m, BEATsModel)
    assert m.embeddername == 'beats'
    assert m.embedder.framelength_s == pytest.approx(9.92)
    assert m.embedder.lookahead_s == pytest.approx(0.015)
    assert m.embedder.n_embeddings == 768
    assert m.transfer_dtype == 'int16'
    assert len(m.config['classes']) == 527
    assert m.config['weights'] == 'seeded'
    assert 'NOT the published checkpoint' in m.config['provenance']
    assert m.model_config == beats.BEATsConfig()
    for bad in (dict(conv='xla'), dict(frontend='pallas'),
                dict(conv_precision='high')):
        with pytest.raises(ValueError, match='YAMNet options'):
            load_model('beats_iter3p_as2m', device='cpu', **bad)
    assert not m.supports_device_resample
    with pytest.raises(NotImplementedError, match='BEATs model gives'):
        m.embedder.embed(np.zeros(16000, np.float32))


def test_a_batch_and_a_ragged_chunk_match_single_chunks():
    m = load_model('beats_tiny', device='cpu', initialize=True)
    a, b = _chunk(3.0, seed=1), _chunk(1.9, seed=2)
    out, n_valid = m.predict_async_batch([a, b])
    assert n_valid == [3, 2]
    for row, x, n in zip(out.numpy(), (a, b), n_valid):
        assert np.allclose(row[:n], m.predict(x), atol=1e-5)


def test_analyze_writes_527_columns(tmp_path):
    import buzzdetect_torch
    from tests.audio_fixtures import write_wav
    x = _chunk(4.0, seed=9).astype(np.float32) / 32768.0
    (tmp_path / 'audio').mkdir()
    write_wav(tmp_path / 'audio' / 'rec.wav', x, 16000)
    a = buzzdetect_torch.analyze(
        modelname='beats_tiny', dir_audio=str(tmp_path / 'audio'),
        dir_out=str(tmp_path / 'out'), chunklength=2.56, device='cpu',
        verbosity_print='ERROR')
    assert a.coordinator.end_reason == 'completed'
    with open(tmp_path / 'out' / 'rec_buzzdetect.csv') as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    assert len(header) == 528
    assert header[1:] == [f'activation_audioset_{i:03d}' for i in range(527)]
    starts = [float(r[0]) for r in body]
    # 1.28 s windows: 4 s of audio in 2.56 s chunks gives 2 + 2 windows
    assert starts == pytest.approx([0.0, 1.28, 2.56, 3.84])
    scores = _port('f32', (x * 32768).astype(np.int16)[:int(2.56 * 16000)])
    assert np.allclose(np.array(body[:2], float)[:, 1:], scores,
                       atol=0.006)


def test_spans_and_counters_on_the_path(monkeypatch):
    """Under a profiler, a chunk's classify holds ``buzzdetect.pos_conv``
    once a block of windows and a ``buzzdetect.post_ln`` twice and a
    ``buzzdetect.attention`` once a layer inside ``buzzdetect.embed``;
    routed to the operators, each launch counts on its wrapper's
    ``launches['post_ln']`` or ``launches['attention_relpos']``."""
    from torch.profiler import ProfilerActivity, profile
    from buzzdetect_torch.ops import library
    from buzzdetect_torch.ops.common import count_launch

    def spy_attention(qkv, heads, rel, gate, scale):
        count_launch(attention.attention_relpos, 'attention_relpos')
        return attention.attention_relpos_plain(qkv, heads, rel, gate, scale)

    def spy_post_ln(x, y, bias, w, b, out, alpha, eps):
        h = epilogue.post_ln_plain(y, bias, x, w, b, alpha, eps,
                                   out is not None)
        if out is not None:
            out.copy_(h)
        count_launch(epilogue.post_ln, 'post_ln')
    monkeypatch.setattr(attention, 'route', lambda x: 'cuda')
    monkeypatch.setattr(epilogue, 'route', lambda x: 'cuda')
    monkeypatch.setattr(library, 'attention_relpos', spy_attention)
    monkeypatch.setattr(library, 'post_ln', spy_post_ln)
    monkeypatch.setattr(library, 'bias_epilogue',
                        lambda y, b, mode: epilogue.plain(mode, y, b))
    monkeypatch.setattr(transformer, 'WINDOW_BLOCK', 2)
    model = load_model('beats_tiny', device='cpu', compute_dtype='bfloat16',
                       initialize=True)
    x = _chunk(4.1, seed=41)               # 4 windows of 1.28 s: 2 blocks
    want = _reference('bf16', x)
    before = (epilogue.post_ln.launches['post_ln'],
              attention.attention_relpos.launches['attention_relpos'])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = model.predict(x)
    assert np.abs(got - want).max() < ATOL['bf16']
    layers = model.model_config.encoder_layers
    assert (epilogue.post_ln.launches['post_ln'] - before[0],
            attention.attention_relpos.launches['attention_relpos']
            - before[1]) == (2 * 2 * layers, 2 * layers)
    names = [e.name for e in prof.events()]
    assert names.count('buzzdetect.pos_conv') == 2
    assert names.count('buzzdetect.post_ln') == 2 * 2 * layers
    assert names.count('buzzdetect.attention') == 2 * layers
    assert names.count('buzzdetect.embed') == 2


# --- the work counts --------------------------------------------------------------

def test_beats_work_counts():
    """``benchmark/roofline_beats.py``'s counts at the published sizes: 496
    tokens, 98.5 GFLOP a window (89.46 in the products, the position
    convolution's 4.68 among them; 9.09 in attention and its gate), 128
    windows in the cell's chunk; attention bound by its bytes; the post-LN's
    683 MB a call."""
    from benchmark import roofline, roofline_beats as r
    sizes = _sizes(FULL)
    assert r.tokens(sizes) == 496
    assert r.linear_flops(sizes) / 1e9 == pytest.approx(89.457, abs=0.001)
    assert 12 * r.attention_flops(sizes) / 1e9 == pytest.approx(9.09,
                                                                abs=0.01)
    peak = roofline.PEAKS['H100 SXM']
    assert r.postln_bound_s(128, sizes, peak) == pytest.approx(
        24 * 128 * 496 * 768 * 14 / peak['bytes'])
    # attention at 496 tokens is bound by its bytes: q, k, v, o and the
    # bias rows, 0.116 ms a block
    assert r.attention_bound_s(128, sizes, peak) == pytest.approx(
        12 * (128 * 4 * 496 * 768 * 2 + 12 * 991 * 4) / peak['bytes'])
    assert 128 * r.attention_flops(sizes) / peak['bf16'] \
        < r.attention_bound_s(128, sizes, peak) / 12
    n = 20_316_400
    config = dict(sizes=sizes, framehop_prop=1.0, reference_function='bf16')
    assert r.chunk_s_at_peak(n, config, peak) * 1e3 == pytest.approx(
        12.78, abs=0.01)


# --- conversion of a checkpoint -----------------------------------------------------

def _state_dict(sizes, seed):
    """A seeded state dict under the published names: the position
    convolution as a weight-norm pair, the bias table in every layer."""
    weights = REFERENCE.seeded(sizes, seed)
    state = {k: torch.from_numpy(v) for k, v in weights.items()}
    w = state.pop('encoder.pos_conv.0.weight')
    g = torch.linalg.vector_norm(w, dim=(0, 1), keepdim=True)
    state['encoder.pos_conv.0.weight_g'] = g
    state['encoder.pos_conv.0.weight_v'] = w * 3.0
    for i in range(1, sizes['encoder_layers']):
        state[f'encoder.layers.{i}.self_attn.relative_attention_bias.'
              f'weight'] = state[REFERENCE.REL_TABLE]
    return state, weights


def test_convert_a_checkpoint(tmp_path):
    """A checkpoint ({'cfg', 'model'}) of the tiny sizes, converted by the
    CLI form and run by the port, matches the reference fed the same
    weights; the weight-norm folds back to the weights it came from."""
    from buzzdetect_torch.models import convert
    sizes = _sizes()
    state, weights = _state_dict(sizes, 23)
    cfg = {k: v for k, v in sizes.items()
           if k not in ('input_fdim', 'input_tdim', 'layer_norm_eps')}
    cfg['finetuned_model'] = True
    path = tmp_path / 'beats_tiny.pt'
    torch.save({'cfg': cfg, 'model': state}, path)
    models = tmp_path / 'models'
    convert.main(['beats', str(path), str(models / 'converted'), '--tdim',
                  '128'])
    config = json.load(open(models / 'converted' / 'config_model.json'))
    assert config['architecture'] == 'beats'
    assert config['sizes'] == sizes
    with np.load(models / 'converted' / 'model.npz') as z:
        assert np.abs(z['encoder.pos_conv.0.weight']
                      - weights['encoder.pos_conv.0.weight']).max() < 1e-6
        assert 'encoder.layers.1.self_attn.relative_attention_bias.weight' \
            not in z.files
    from buzzdetect_torch import config as bz_config
    old = bz_config.DIR_MODELS
    bz_config.DIR_MODELS = str(models)
    try:
        m = load_model('converted', device='cpu', initialize=True)
        x = _chunk(2.5, seed=5)
        got = m.predict(x)
    finally:
        bz_config.DIR_MODELS = old
    s, w = REFERENCE.load_weights(str(models / 'converted'), 'cpu')
    want = REFERENCE.classify(w, s, x, 1.0, 'f32', block=2)
    assert np.abs(got - want).max() < ATOL['f32']
    with pytest.raises(ValueError, match='missing'):
        convert.beats_npz_from_state_dict(
            {k: v for k, v in state.items() if 'fc2' not in k},
            beats.BEATsConfig.from_sizes(sizes))


def test_the_converter_reads_the_checkpoint_cfg():
    """The checkpoint's cfg wins over the published defaults; keys the
    checkpoint leaves out take ``BEATsConfig``'s published defaults (a
    max_distance of 1280, deep norm off, which the port refuses)."""
    from buzzdetect_torch.models import convert
    cfg = dict(_sizes(FULL))
    for k in ('input_fdim', 'input_tdim', 'layer_norm_eps'):
        del cfg[k]
    assert convert.beats_config_from_cfg(cfg) == beats.BEATsConfig()
    cfg['max_distance'] = 1280
    assert convert.beats_config_from_cfg(cfg).max_distance == 1280
    del cfg['deep_norm']
    with pytest.raises(ValueError, match='deep_norm'):
        convert.beats_config_from_cfg(cfg)


# --- on the card -------------------------------------------------------------------

@pytest.fixture(scope='module')
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the relative-position attention and '
                    'the post-LN kernels of csrc/attention.cu and '
                    'csrc/epilogue.cu run only there')
    return torch.device('cuda')


def _gate_operands(card):
    cfg = beats.BEATsConfig()
    p = beats.seeded_params(cfg, 20221218)
    a = 'encoder.layers.7.self_attn.'
    rel = torch.from_numpy(beats.bias_rows(p[beats.REL_TABLE], cfg.tokens,
                                           cfg)).to(card)
    gate = torch.from_numpy(beats.fold_gate(
        p[a + 'grep_linear.weight'], p[a + 'grep_linear.bias'],
        p[a + 'grep_a'])).to(card)
    return rel, gate


@pytest.mark.card
@pytest.mark.parametrize('dtype,windows', [(torch.bfloat16, 128),
                                           (torch.float32, 8)])
def test_attention_relpos_kernel_matches_its_plain_version(card, dtype,
                                                           windows):
    """The kernel at the cell's shape (windows x 12 heads x 496 x 64)
    against ``attention_relpos_plain``, 16 windows at a time: within two
    bf16 ulps of the largest v (P rounded before the normalisation in the
    kernel, after it in the plain version), or 2e-5 in f32; and the bias
    moves it by far more than that."""
    rel, gate = _gate_operands(card)
    gen = torch.Generator(device=card).manual_seed(windows)
    qkv = (torch.randn((windows, 496, 3 * 768), device=card, generator=gen)
           * 0.7).to(dtype)
    before = attention.attention_relpos.launches['attention_relpos']
    got = attention.attention_relpos(qkv, 12, rel, gate)
    assert attention.attention_relpos.launches['attention_relpos'] \
        == before + 1
    atol = (2.0 ** -7 * float(qkv[..., 1536:].float().abs().max())
            if dtype == torch.bfloat16 else 2e-5)
    gap = 0.0
    for lo in range(0, windows, 16):
        want = attention.attention_relpos_plain(qkv[lo:lo + 16], 12, rel,
                                                gate)
        gap = max(gap, float((got[lo:lo + 16].float()
                              - want.float()).abs().max()))
    print(f'{dtype}: max |kernel - plain| = {gap:.3g} (atol {atol:.3g})')
    assert gap <= atol
    unbiased = attention.attention(qkv[:8].contiguous(), 12)
    assert float((unbiased.float() - got[:8].float()).abs().max()) \
        > 10 * atol


@pytest.mark.card
def test_post_ln_kernel_matches_its_plain_version(card):
    """At the cell's 63,488 x 768: the f32 stream within 1e-5 of
    ``post_ln_plain`` (LayerNorm's statistics summed in another order),
    the bf16 operand within one bf16 ulp of the largest value."""
    gen = torch.Generator(device=card).manual_seed(9)
    rows = 128 * 496
    y = torch.randn((rows, 768), device=card, generator=gen) * 0.3
    x = torch.randn((rows, 768), device=card, generator=gen)
    b, nb = (torch.randn(768, device=card, generator=gen) * 0.1
             for _ in range(2))
    w = 1 + torch.randn(768, device=card, generator=gen) * 0.1
    alpha = beats.BEATsConfig().alpha
    got_x, want_x = x.clone(), x.clone()
    before = epilogue.post_ln.launches['post_ln']
    got = epilogue.post_ln(y, b, got_x, w, nb, alpha, 1e-5, True)
    assert epilogue.post_ln.launches['post_ln'] == before + 1
    want = epilogue.post_ln_plain(y, b, want_x, w, nb, alpha, 1e-5, True)
    gap = float((got_x - want_x).abs().max())
    print(f'post_ln: max |kernel - plain| = {gap:.3g}')
    assert gap <= 1e-5
    assert float((got.float() - want.float()).abs().max()) \
        <= 2.0 ** -8 * float(want_x.abs().max())
    assert epilogue.post_ln(y, b, got_x, w, nb, alpha, 1e-5, False) is None


@pytest.mark.card
def test_one_chunk_launches_each_kernel_once_a_layer(card):
    """A 128-window chunk through ``load_model('beats_iter3p_as2m', bf16)``:
    12 attention launches and 24 post-LNs, and scores within the cell's
    ``score_gap`` limit of the reference's bf16 function."""
    spec = json.load(open(os.path.join(
        REPO, 'benchmark', 'workloads', 'beats.bf16.long_chunks.pinned.json')))
    m = load_model('beats_iter3p_as2m', compute_dtype='bfloat16',
                   initialize=True)
    x = _chunk(1269.775, seed=77)
    before = (attention.attention_relpos.launches['attention_relpos'],
              epilogue.post_ln.launches['post_ln'])
    got = m.predict(x)
    assert (attention.attention_relpos.launches['attention_relpos']
            - before[0], epilogue.post_ln.launches['post_ln']
            - before[1]) == (12, 24)
    want = REFERENCE.scores({'model': 'beats_iter3p_as2m'}, {0: x}, card,
                            'bf16')[0]
    assert got.shape == want.shape == (128, 527)
    gap = float(np.abs(got - want).max())
    print(f'one chunk: max |port - reference bf16| = {gap:.3g}')
    assert gap <= spec['limits']['score_gap']
