"""The Audio Spectrogram Transformer on the port (``models/ast.py``, the
Kaldi geometry of ``ops/logmel.py``, ``ops/attention.py``, the registry's
``ASTModel``, ``models/convert``'s AST branch), on the CPU at tiny sizes
(``models/ast_tiny``: width 64, 2 blocks, 4 heads of 16, 128 mel bins,
128-frame windows) on seeded weights, against the plain reference
``benchmark/reference/ast.py`` loaded by its path.

Tolerances:

* f32: 2e-6 on logits of about 0.2: the port's products (the patches as a
  matmul, the attention by heads) sum in another order than the
  reference's (``F.conv2d``, ``F.linear``), a few f32 ulps;
* bf16: 5e-3: the same function, but an operand within an f32 ulp of a
  bf16 rounding edge rounds the other way when the sums before it ran in
  another order, and each such flip moves a product by 2^-8 of a term;
  the fp8 control (``'fp8'``) differs from the bf16 reference by more than
  2e-2 here, so computing in the precision below would fail it;
* the fbank: 1e-4 after AST's normalisation (log power / 9.14): the port's
  power comes from a DFT product, the reference's from ``torch.fft.rfft``.
"""

import csv
import json
import os
import zlib

import numpy as np
import pytest
import torch

from benchmark.manifest import load_module
from buzzdetect_torch.models import ast
from buzzdetect_torch.models.registry import ASTModel, load_model
from buzzdetect_torch.ops import attention, epilogue, logmel, mel
from tests.audio_fixtures import write_wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, 'models', 'ast_tiny')
FULL = os.path.join(REPO, 'models', 'ast_audioset_10s')
REFERENCE = load_module(os.path.join(REPO, 'benchmark', 'reference',
                                     'ast.py'), 'test_ast_reference')
ATOL = {'f32': 2e-6, 'bf16': 5e-3}
DTYPES = {'f32': None, 'bf16': 'bfloat16'}


def _chunk(seconds, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(int(16000 * seconds)) * 3000
    x[::7] += 6000 * np.sin(np.arange(len(x[::7])) * 0.05)
    return np.clip(x, -32768, 32767).astype(np.int16)


def _port(precision, samples, framehop=1.0, model='ast_tiny'):
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
    cfg = ast.ASTConfig.from_sizes(json.load(open(os.path.join(
        TINY, 'config_model.json')))['sizes'])
    port = ast.seeded_params(cfg, 11)
    ref = REFERENCE.seeded(json.load(open(os.path.join(
        TINY, 'config_model.json')))['sizes'], 11)
    assert list(port) == list(ref)
    for k in port:
        assert port[k].dtype == ref[k].dtype == np.float32
        assert np.array_equal(port[k], ref[k]), k
    # the published sizes name the same tensors at the same shapes: 86.6M
    sizes = json.load(open(os.path.join(FULL, 'config_model.json')))['sizes']
    shapes = ast.param_shapes(ast.ASTConfig.from_sizes(sizes))
    assert list(shapes.items()) == REFERENCE.names_and_shapes(sizes)
    assert sum(int(np.prod(s)) for s in shapes.values()) == 86_594_063
    # the recipe: one stream per name, N(0, 0.02^2)
    name = 'v.blocks.1.attn.qkv.weight'
    rng = np.random.default_rng(np.random.SeedSequence(
        [11, zlib.crc32(name.encode())]))
    assert np.array_equal(port[name], (rng.standard_normal(
        port[name].shape) * 0.02).astype(np.float32))
    assert np.all(port['v.blocks.0.norm1.weight'] == 1)
    assert np.all(port['mlp_head.1.bias'] == 0)


@pytest.mark.parametrize('bf16', [False, True])
def test_the_last_block_keeps_the_two_tokens_it_would_compute(bf16):
    """The encoder's last block carries only tokens 0 and 1 past attention:
    their rows are those of the whole block."""
    cfg = ast.ASTConfig.from_sizes(json.load(open(os.path.join(
        TINY, 'config_model.json')))['sizes'])
    p = ast.pack_params(ast.seeded_params(cfg, 3), cfg, 'cpu', bf16)
    x = torch.randn(3, cfg.tokens, cfg.embed_dim,
                    generator=torch.Generator().manual_seed(4))
    whole = ast.block(p, 1, ast.block(p, 0, x.clone(), cfg, bf16), cfg, bf16)
    kept = ast.encoder(p, x.clone(), cfg, bf16)
    assert kept.shape == (3, 2, cfg.embed_dim)
    assert torch.allclose(kept, whole[:, :2], atol=1e-6, rtol=1e-6)


# --- the Kaldi fbank ------------------------------------------------------------

def _hand_mel_bank(bins=128, fft=512, rate=16000.0, low=20.0, high=8000.0):
    """Kaldi's mel banks as torchaudio's get_mel_banks builds them, in
    float32 torch, with its padded Nyquist column, as (257, bins)."""
    def scale(f):
        return 1127.0 * torch.log(1.0 + f / 700.0)
    lo, hi = scale(torch.tensor(low)), scale(torch.tensor(high))
    delta = (hi - lo) / (bins + 1)
    b = torch.arange(bins).unsqueeze(1)
    left, center, right = lo + b * delta, lo + (b + 1.0) * delta, \
        lo + (b + 2.0) * delta
    m = scale(rate / fft * torch.arange(fft // 2)).unsqueeze(0)
    up = (m - left) / (center - left)
    down = (right - m) / (right - center)
    banks = torch.max(torch.zeros(1), torch.min(up, down))
    return torch.nn.functional.pad(banks, (0, 1)).T.numpy()


def test_kaldi_mel_matrix_matches_a_hand_built_bank():
    got = mel.kaldi_mel_matrix()
    want = _hand_mel_bank()
    assert got.shape == want.shape == (257, 128)
    assert np.abs(got - want).max() < 2e-5
    assert np.all(got[-1] == 0)
    # each band a triangle: rising, then falling, over whole bins
    for band in got.T[::17]:
        peak = int(np.argmax(band))
        assert np.all(np.diff(band[:peak + 1]) >= 0)
        assert np.all(np.diff(band[peak:]) <= 0)
    assert np.abs(REFERENCE.mel_banks(128).numpy() - got).max() < 1e-6


@pytest.mark.parametrize('dtype', [torch.int16, torch.float32])
def test_kaldi_fbank_plain_matches_the_reference(dtype):
    x = _chunk(2.0, seed=4)
    wav = torch.from_numpy(x)
    if dtype == torch.float32:
        wav = wav.float() / 32768.0
    got = logmel.log_mel_spectrogram_fused(wav, logmel.KaldiFbankConfig())
    want = REFERENCE.fbank(torch.from_numpy(x).float() / 32768.0, 128)
    assert got.shape == want.shape == (1 + (len(x) - 400) // 160, 128)
    assert float((got - want).abs().max()) < 1e-4


def test_kaldi_fbank_frames_as_kaldi_does():
    """A frame with its DC and a pure pre-emphasis response: a constant
    frame has no energy after the mean is removed (every band at the
    floor), and the plain version's pre-emphasis takes the first sample as
    its own predecessor."""
    cfg = logmel.KaldiFbankConfig()
    const = torch.full((400,), 0.25)
    out = logmel.log_mel_spectrogram_fused(const, cfg)
    floor = (np.log(np.finfo(np.float32).eps) + cfg.shift) / cfg.divisor
    assert torch.allclose(out, torch.full_like(out, floor))
    assert cfg.divisor == pytest.approx(9.1379948)


@pytest.mark.parametrize('other', [
    dict(mel_bands=64), dict(window_samples=512), dict(hop_samples=320),
    dict(fft_length=1024)])
def test_check_geometry_takes_exactly_two(other):
    from buzzdetect_torch.ops.frontend import FrontendConfig
    assert logmel._check_geometry(FrontendConfig()) == 'yamnet'
    assert logmel._check_geometry(logmel.KaldiFbankConfig()) == 'kaldi'
    with pytest.raises(ValueError, match='Kaldi fbank geometry'):
        logmel._check_geometry(logmel.KaldiFbankConfig(**other))


def test_kaldi_tables_hold_the_symmetric_window():
    half = logmel.fft_tables(symmetric=True)[0]
    n = np.arange(400)
    want = 0.5 * (0.5 - 0.5 * np.cos(2 * np.pi * n / 399))
    assert np.abs(half - want).max() < 1e-7
    assert half[0] == half[-1] == 0.0
    assert np.array_equal(logmel.fft_tables()[1], logmel.fft_tables(
        symmetric=True)[1])


# --- the attention kernel's schedule ---------------------------------------------

@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('n', [1214, 64, 65, 1, 130])
def test_attention_schedule_matches_plain_softmax(dtype, n):
    """The kernel's block schedule (tiles of 64 keys, the masked tail,
    online softmax, P rounded at the running maximum) against one softmax:
    1,214 keys are 18 tiles and a tail of 62."""
    gen = torch.Generator().manual_seed(n)
    qkv = (torch.randn(2, n, 3 * 2 * 64, generator=gen) * 1.5).to(dtype)
    plain = attention.attention_plain(qkv, 2).float()
    blocked = attention.attention_blocked(qkv, 2).float()
    assert blocked.shape == plain.shape == (2, n, 128)
    # bf16: P rounded at the running maximum rather than after the division
    # (2^-8 relative a term) and the output's own rounding; f32: exp and
    # each tile's rescale round apart, a few ulps over 19 tiles
    tol = (2.0 ** -7 * float(plain.abs().max()) if dtype == torch.bfloat16
           else 1e-5)
    assert float((blocked - plain).abs().max()) <= tol


def test_attention_plain_is_softmax_attention_by_heads():
    gen = torch.Generator().manual_seed(3)
    qkv = torch.randn(1, 9, 3 * 3 * 16, generator=gen)
    got = attention.attention_plain(qkv, 3)
    q, k, v = qkv.view(1, 9, 3, 3, 16).permute(2, 0, 3, 1, 4)
    want = torch.softmax(q @ k.transpose(-1, -2) / 4.0, -1) @ v
    assert torch.allclose(got, want.transpose(1, 2).reshape(1, 9, 48),
                          atol=1e-6)
    # one launch a block; 12 blocks of a 128-window chunk: 6.95 TFLOP
    assert 12 * attention.attention_flops(128, 1214, 12) == pytest.approx(
        6.95e12, rel=1e-3)


# --- the products' epilogues ------------------------------------------------------

@pytest.mark.parametrize('mode', epilogue.MODES)
def test_epilogue_plain_modes(mode):
    gen = torch.Generator().manual_seed(5)
    y = torch.randn(6, 12, generator=gen) * 3
    b = torch.randn(12, generator=gen)
    x = torch.randn(6, 12, generator=gen)
    want = {'bias_bf16': (y + b).to(torch.bfloat16),
            'bias_gelu_bf16': torch.nn.functional.gelu(y + b).to(
                torch.bfloat16),
            'bias_residual': x + (y + b)}[mode]
    got = epilogue.apply(mode, y, b, x.clone())
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_epilogue_routes_cuda_through_the_ops(monkeypatch):
    """On a CUDA tensor ``apply`` calls the operators with the mode; the
    operators themselves refuse CPU tensors."""
    from buzzdetect_torch.ops import library
    calls = []
    monkeypatch.setattr(library, 'bias_epilogue',
                        lambda y, b, mode: calls.append(mode) or y)
    monkeypatch.setattr(library, 'bias_residual',
                        lambda x, y, b: calls.append('residual'))
    monkeypatch.setattr(epilogue, '_route', lambda t: 'cuda')
    y, b, x = torch.zeros(2, 8), torch.zeros(8), torch.zeros(2, 8)
    epilogue.apply('bias_bf16', y, b)
    epilogue.apply('bias_gelu_bf16', y, b)
    assert epilogue.apply('bias_residual', y, b, x) is x
    assert calls == ['bias_bf16', 'bias_gelu_bf16', 'residual']
    monkeypatch.undo()
    before = epilogue.apply.launches
    with pytest.raises(NotImplementedError, match='CPU'):
        library.bias_epilogue(y, b, 'bias_bf16')
    with pytest.raises(NotImplementedError, match='CPU'):
        library.bias_residual(x, y, b)
    with pytest.raises(ValueError, match='mode'):
        epilogue.apply('bias', y, b)
    assert epilogue.apply.launches == before


# --- windows, the registry, analyze() --------------------------------------------

@pytest.mark.parametrize('n,framehop,windows,padded', [
    (20_971_760, 1.0, 128, 20_971_760),     # the benchmark's chunk
    (164_080, 1.0, 1, 164_080),             # one window exactly
    (164_081, 1.0, 2, 327_920),             # one sample more
    (100, 1.0, 1, 164_080),                 # shorter than a window
    (16000 * 30, 0.5, 5, 164_080 + 4 * 81_920),
    (16000 * 30, 1.0, 3, 164_080 + 2 * 163_840)])
def test_window_counts_and_padding(n, framehop, windows, padded):
    m = load_model('ast_audioset_10s', device='cpu', framehop_prop=framehop)
    clf = ast.ASTClassifier.__new__(ast.ASTClassifier)
    clf.cfg, clf.fbank = m.ast_config, logmel.KaldiFbankConfig()
    clf.hop_frames = ast.window_hop_frames(m.ast_config, framehop)
    assert (clf._valid(n), clf._padded(n)) == (windows, padded)
    assert REFERENCE.n_windows(n, 1024, clf.hop_frames) == windows
    assert m.embedder.framehop_s == pytest.approx(10.24 * framehop)


def test_the_model_directory_and_its_options():
    m = load_model('ast_audioset_10s', device='cpu')
    assert isinstance(m, ASTModel)
    assert m.embedder.framelength_s == pytest.approx(10.24)
    assert m.embedder.lookahead_s == pytest.approx(0.015)
    assert m.transfer_dtype == 'int16'
    assert m.config['classes'][:2] == ['audioset_000', 'audioset_001']
    assert len(m.config['classes']) == 527
    assert m.config['weights'] == 'seeded'
    assert 'NOT the published checkpoint' in m.config['provenance']
    assert ast.ASTConfig.from_sizes(m.config['sizes']) == ast.ASTConfig()
    for bad in (dict(conv='xla'), dict(frontend='pallas'),
                dict(conv_precision='high')):
        with pytest.raises(ValueError, match='YAMNet options'):
            load_model('ast_audioset_10s', device='cpu', **bad)
    assert not m.supports_device_resample


def test_a_batch_and_a_ragged_chunk_match_single_chunks():
    m = load_model('ast_tiny', device='cpu', initialize=True)
    a, b = _chunk(3.0, seed=1), _chunk(1.9, seed=2)
    out, n_valid = m.predict_async_batch([a, b])
    assert n_valid == [3, 2]
    for row, x, n in zip(out.numpy(), (a, b), n_valid):
        assert np.allclose(row[:n], m.predict(x), atol=1e-5)


def test_analyze_writes_one_row_per_window(tmp_path):
    import buzzdetect_torch
    seconds = 4.0
    x = _chunk(seconds, seed=9).astype(np.float32) / 32768.0
    (tmp_path / 'audio').mkdir()
    write_wav(tmp_path / 'audio' / 'rec.wav', x, 16000)
    a = buzzdetect_torch.analyze(
        modelname='ast_tiny', dir_audio=str(tmp_path / 'audio'),
        dir_out=str(tmp_path / 'out'), chunklength=2.56, device='cpu',
        verbosity_print='ERROR')
    assert a.coordinator.end_reason == 'completed'
    with open(tmp_path / 'out' / 'rec_buzzdetect.csv') as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    assert header[1:] == [f'activation_audioset_{i:03d}' for i in range(527)]
    starts = [float(r[0]) for r in body]
    # 1.28 s windows: 4 s of audio in 2.56 s chunks gives 2 + 2 windows
    assert starts == pytest.approx([0.0, 1.28, 2.56, 3.84])
    scores = _port('f32', (x * 32768).astype(np.int16)[:int(2.56 * 16000)])
    assert np.allclose(np.array(body[:2], float)[:, 1:], scores,
                       atol=0.006)


def test_ast_work_counts():
    """``benchmark/roofline_ast.py``'s counts at the published sizes: 1,214
    tokens, 261 GFLOP a window (206.7 in the products, 54.3 in attention),
    128 windows and 131,072 frames in the cell's chunk, nothing padded, and
    the chunk's fbank."""
    from benchmark import roofline, roofline_ast as r
    sizes = json.load(open(os.path.join(FULL, 'config_model.json')))['sizes']
    n = 20_971_760
    assert r.tokens(sizes) == 1214
    assert (r.windows(n, sizes), r.frames(n, sizes),
            r.padded_samples(n, sizes)) == (128, 131_072, n)
    assert r.linear_flops(sizes) / 1e9 == pytest.approx(206.70, abs=0.01)
    assert r.attention_flops(sizes) / 1e9 == pytest.approx(54.33, abs=0.01)
    peak = roofline.PEAKS['H100 SXM']
    assert r.attention_bound_s(128, sizes, peak) * 1e3 == pytest.approx(
        7.03, abs=0.01)
    assert n / 16000 / r.chunk_s_at_peak(n, dict(
        sizes=sizes, framehop_prop=1.0, reference_function='bf16'),
        peak) == pytest.approx(38_764, rel=1e-3)
    # the chunk's fbank: 2.01 GFLOP, bound by its 109 MB at the memory's peak
    assert r.fbank_flops(131_072) / 1e9 == pytest.approx(2.005, abs=1e-3)
    assert r.fbank_bound_s(n, dict(sizes=sizes, framehop_prop=1.0,
                                   transfer_dtype='int16'), peak) \
        == pytest.approx((2 * n + 131_072 * 128 * 4) / peak['bytes'])


@pytest.mark.parametrize('bands', [128, 64])
def test_fbank_count_takes_the_banks_nonzeros(bands):
    """``roofline_ast.mel_nonzeros``, computed from the sizes alone, counts
    the nonzero weights of the port's Kaldi mel matrix: the mel product's
    work is the banks' triangles, not the dense 257 x ``bands``."""
    from benchmark import roofline_ast as r
    from buzzdetect_torch.ops.mel import kaldi_mel_matrix
    assert r.mel_nonzeros(bands) == int(
        np.count_nonzero(kaldi_mel_matrix(num_mel_bins=bands)))


# --- conversion of a published state dict -----------------------------------------

def test_convert_a_published_state_dict(tmp_path):
    """A seeded tiny state dict under the published key names (DataParallel's
    ``module.``, DeiT's unused heads), converted and run by the port,
    matches the reference fed the same state dict."""
    from buzzdetect_torch.models import convert
    sizes = json.load(open(os.path.join(TINY, 'config_model.json')))['sizes']
    weights = REFERENCE.seeded(sizes, 23)
    state = {'module.' + k: torch.from_numpy(v) for k, v in weights.items()}
    state['module.v.head.weight'] = torch.zeros(1000, 64)
    state['module.v.head_dist.weight'] = torch.zeros(1000, 64)
    path = tmp_path / 'ast_tiny_published.pth'
    torch.save(state, path)
    models = tmp_path / 'models'
    convert.main(['ast', str(path), str(models / 'converted'), '--heads',
                  '4', '--tdim', '128'])
    config = json.load(open(models / 'converted' / 'config_model.json'))
    assert config['architecture'] == 'ast'
    assert {k: config['sizes'][k] for k in sizes} == sizes
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
        convert.ast_npz_from_state_dict(
            {k: v for k, v in state.items() if 'norm2' not in k},
            ast.ASTConfig.from_sizes(sizes))
