"""The port's fused log-mel (ops/logmel.py) against the Pallas frontend.

The plain version runs here, on the CPU; the JAX side runs
``log_mel_spectrogram_pallas`` in interpret mode, as tests/test_pallas.py
does. The CUDA kernel itself is held against the plain version on the card
by chip_smoke.py; here its FFT schedule is checked by a numpy emulation of
the kernel's stages on the tables ``logmel.fft_tables`` builds, its launch
geometry by counting what each block computes, and the classifier's
per-device choice of frontend by ``resolve_frontend``.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from buzzdetect_tpu import config as jcfg
from buzzdetect_tpu.models.classifier import ChunkClassifier as JaxClassifier
from buzzdetect_tpu.ops import frontend as jfe
from buzzdetect_tpu.ops.pallas_frontend import log_mel_spectrogram_pallas
from buzzdetect_torch.models.classifier import ChunkClassifier
from buzzdetect_torch.ops import frontend as tfe
from buzzdetect_torch.ops import logmel

# As tests/test_pallas.py (pallas against the XLA frontend): both sides are
# exact f32 products of ~400 and ~257 terms summed in different orders,
# and the log amplifies a product's rounding by at most 1/(mel + 1e-3).
ATOL, RTOL = 2e-4, 1e-5
# Scores: the BASELINE.md parity budget.
ATOL_SCORE = 1e-3
BUNDLE = os.path.join(jcfg.DIR_REPO, 'models', 'model_general_v3',
                      'model.npz')


def _wave(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * 0.1).astype(np.float32)


def _report(name, got, ref):
    err = float(np.abs(got - ref).max())
    print(f'{name}: max |port - pallas| = {err:.3g}')
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize('seconds', [1.0, 4.8, 10.0])
def test_plain_matches_pallas(seconds):
    cfg = jfe.FrontendConfig().with_framehop(1.0)
    padded = np.array(jfe.pad_waveform(_wave(int(seconds * 16000), 5),
                                         cfg))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(log_mel_spectrogram_pallas(jnp.asarray(padded), cfg))
    got = logmel.log_mel_spectrogram_fused_plain(
        torch.from_numpy(padded), tfe.FrontendConfig()).numpy()
    assert got.shape == ref.shape == (1 + (len(padded) - 400) // 160, 64)
    _report(f'log_mel {seconds} s', got, ref)


def test_ragged_frame_count_and_batch():
    """A length that is no whole number of hops (the kernel's last frame
    tile is ragged too), and a (B, n) batch whose rows are each held
    against the Pallas kernel on that row alone."""
    cfg = tfe.FrontendConfig()
    n = 400 + 160 * 77 + 33                 # 78 frames, 33 samples spare
    wavs = np.stack([_wave(n, s) * g for s, g in ((1, 1.0), (2, 0.01),
                                                  (3, 3.0))])
    got = logmel.log_mel_spectrogram_fused(torch.from_numpy(wavs),
                                           cfg).numpy()
    assert got.shape == (3, 78, 64)
    with pltpu.force_tpu_interpret_mode():
        for i in range(3):
            ref = np.asarray(log_mel_spectrogram_pallas(
                jnp.asarray(wavs[i]), jfe.FrontendConfig()))
            _report(f'log_mel batch row {i} (n={n})', got[i], ref)
    np.testing.assert_array_equal(
        got[1], logmel.log_mel_spectrogram_fused(torch.from_numpy(wavs[1]),
                                                 cfg).numpy())


# --- a numpy emulation of csrc/logmel.cu's FFT, stage for stage ----------------

def _dft4(v):
    """4-point DFT of four (re, im) pairs, natural order (W4 = -i)."""
    (r0, i0), (r1, i1), (r2, i2), (r3, i3) = v
    b0, b1 = (r0 + r2, i0 + i2), (r0 - r2, i0 - i2)
    b2, b3 = (r1 + r3, i1 + i3), (r1 - r3, i1 - i3)
    return [(b0[0] + b2[0], b0[1] + b2[1]), (b1[0] + b3[1], b1[1] - b3[0]),
            (b0[0] - b2[0], b0[1] - b2[1]), (b1[0] - b3[1], b1[1] + b3[0])]


def _cmul(v, w):
    (a, b), (wr, wi) = v, w
    return a * wr - b * wi, a * wi + b * wr


def _dft16(v, w256):
    """The kernel's dft16: j = j1 + 4 j2, a 4-point DFT over j2, the
    twiddles W16^(j1 p) (W16^2 and W16^6 from cos(pi / 4), W16^4 = -i
    exact), a 4-point DFT over j1, outputs renamed from 4 p + q to
    p + 4 q."""
    v = list(v)
    for j1 in range(4):
        v[j1::4] = _dft4(v[j1::4])
    for pos, e in ((5, 1), (13, 3), (7, 3), (15, 9)):
        v[pos] = _cmul(v[pos], w256[16 * e])
    h = w256[32, 0]
    for pos in (9, 6):
        a, b = v[pos]
        v[pos] = (h * (a + b), h * (b - a))
    for pos in (14, 11):
        a, b = v[pos]
        v[pos] = (h * (b - a), -(h * (a + b)))
    v[10] = (v[10][1], -v[10][0])
    for p in range(4):
        v[4 * p:4 * p + 4] = _dft4(v[4 * p:4 * p + 4])
    return [v[4 * (k % 4) + k // 4] for k in range(16)]


def _emulate_fft(frames):
    """(N, 400) f32 frames -> (N, 257) complex spectra, in f32, by the
    kernel's schedule: the halved window, 256 packed points, pass 1 (thread
    t: z[t + 16 j] over j, times W256^(t k2)), the transpose, pass 2 (thread
    k2 over t: Z[k2 + 16 k1]), and the even/odd post-twiddle from each
    thread's k1 < 8 and its partner's Z[256 - k]; bin 128 from thread 0."""
    half, w256, w512, passes = logmel.fft_tables()
    u = frames.astype(np.float32) * half
    z = np.zeros((len(frames), 256, 2), np.float32)
    z[:, :200, 0], z[:, :200, 1] = u[:, 0::2], u[:, 1::2]
    rows = []
    for t in range(16):
        a = _dft16([(z[:, t + 16 * j, 0], z[:, t + 16 * j, 1])
                    for j in range(16)], w256)
        rows.append([_cmul(a[k2], passes[k2, t]) for k2 in range(16)])
    zz = [_dft16([rows[t][k2] for t in range(16)], w256) for k2 in range(16)]
    spectrum = np.zeros((len(frames), 257), np.complex64)
    for t in range(16):
        for k1 in range(8):
            k = t + 16 * k1
            a, b = zz[t][k1]
            c, d = (zz[0][(16 - k1) % 16] if t == 0 else
                    zz[16 - t][15 - k1])
            e = (a + c, b - d)
            o = _cmul((b + d, c - a), w512[k])
            spectrum[:, k] = (e[0] + o[0]) + 1j * (e[1] + o[1])
            spectrum[:, 256 - k] = (e[0] - o[0]) - 1j * (e[1] - o[1])
    a, b = zz[0][8]
    spectrum[:, 128] = (a + a) - 1j * (b + b)
    return spectrum


@pytest.mark.parametrize('frames', [1, 480, 20064])
def test_fft_schedule_reproduces_rfft(frames):
    """The kernel's stage order and twiddle tables, emulated in f32 on
    seeded frames, give np.fft.rfft of the windowed frames zero-padded to
    512 (float64), every bin within f32 rounding of the largest: bins 0
    and 256 (both from Z[0]), bin 128 (thread 0's extra) and each even/odd
    pair k, 256 - k (one post-twiddle)."""
    rng = np.random.default_rng(frames)
    x = (rng.standard_normal((frames, 400)) * 0.1).astype(np.float32)
    got = _emulate_fft(x)
    n = np.arange(400)
    ref = np.fft.rfft(x.astype(np.float64)
                      * (0.5 - 0.5 * np.cos(2 * np.pi * n / 400)), 512)
    scale = np.abs(ref).max()
    err = np.abs(got - ref) / scale
    print(f'{frames} frames: max |emulated - rfft| / max |rfft| = '
          f'{err.max():.3g}; bins 0, 128, 256: {err[:, 0].max():.3g}, '
          f'{err[:, 128].max():.3g}, {err[:, 256].max():.3g}')
    assert err.max() < 2e-6
    assert np.abs(got[:, [0, 256]].imag).max() == 0
    # the pairs of one post-twiddle are conjugate halves of one frame's
    # spectrum: |X[k]| and |X[256 - k]| both as rfft has them
    k = np.arange(1, 128)
    np.testing.assert_allclose(np.abs(got[:, 256 - k]),
                               np.abs(ref[:, 256 - k]), atol=2e-6 * scale)


def test_fft_tables_are_float64_rounded_once():
    """The window (periodic Hann, halved: exact) and the twiddles, computed
    in float64 and rounded once to f32 (pass 1's are W256's entries t k2,
    laid out [k2, t]); the operands hold them in one flat tensor beside the
    matmul frontend's own mel matrix and DFT."""
    half, w256, w512, passes = logmel.fft_tables()
    n = np.arange(400)
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * n / 400)
    np.testing.assert_array_equal(half, hann.astype(np.float32) / 2)
    e = -2 * np.pi * np.arange(256) / 256
    np.testing.assert_array_equal(
        w256, np.stack([np.cos(e), np.sin(e)], 1).astype(np.float32))
    k = -2 * np.pi * np.arange(128) / 512
    np.testing.assert_array_equal(
        w512, np.stack([np.cos(k), np.sin(k)], 1).astype(np.float32))
    cfg = tfe.FrontendConfig()
    ops = logmel._operands(cfg, torch.device('cpu'))
    for k2 in range(16):
        for t in range(16):
            np.testing.assert_array_equal(passes[k2, t], w256[t * k2])
    np.testing.assert_array_equal(
        ops['tables'].numpy(),
        np.concatenate([half, w256.reshape(-1), w512.reshape(-1),
                        passes.reshape(-1)]))
    banks, mel = tfe._dft_mel_constants_np(400, 512, 160, 64, 257, 16000,
                                           125.0, 7500.0)
    np.testing.assert_array_equal(banks.reshape(-1, 514)[:400],
                                  ops['dft'].numpy())
    np.testing.assert_array_equal(mel, ops['mel'].numpy())


# (frames per waveform, batch): one 200 s chunk (B = 209 patches), a file's
# ragged last chunk (B = 5), and ragged counts around the frame tiles
GEOMETRY_CASES = [(20064, 1), (480, 1)] + [
    (frames, batch) for frames in (1, 63, 65, 4097) for batch in (1, 3)]


@pytest.mark.parametrize('sms', [132, 8])
@pytest.mark.parametrize('frames,batch', GEOMETRY_CASES)
def test_launch_geometry_covers_every_frame_once(frames, batch, sms):
    """Every (batch row, frame) is one block's, with all its bins and
    bands: the grid holds whole tiles of the chosen FT."""
    g = logmel.launch_geometry(frames, batch, sms)
    assert g.ft in logmel.FRAME_TILES and g.threads == 4 * g.ft
    assert g.grid == (-(-frames // g.ft), batch)
    assert g.blocks == g.grid[0] * g.grid[1]
    owner = np.full((batch, frames), -1)
    for by in range(g.grid[1]):
        for bx in range(g.grid[0]):
            row, fr = logmel.block_work(g, frames, bx, by)
            assert row == by and 0 < len(fr) <= g.ft
            assert (owner[row, fr.start:fr.stop] == -1).all()
            owner[row, fr.start:fr.stop] = bx
    assert (owner >= 0).all()


def test_launch_geometry_fills_the_card_for_a_ragged_last_chunk():
    """B = 5 (480 frames) was 8 blocks on 132 SMs; now at least 60."""
    g = logmel.launch_geometry(480, 1, 132)
    assert g.blocks >= 60
    print(f'B=5: FT {g.ft}, {g.blocks} blocks')


def _balance(frames, sms=132):
    """The busiest SM's frames over the mean, counted from the grid of
    ``launch_geometry``'s pick (blocks dealt to the SMs in turn, as the
    card fills a wave)."""
    g = logmel.launch_geometry(frames, 1, sms)
    work = [len(fr) for _row, fr in
            (logmel.block_work(g, frames, bx, 0) for bx in range(g.grid[0]))]
    per_sm = [sum(work[i::sms]) for i in range(sms)]
    mean = frames / sms
    assert mean == g.mean and max(per_sm) <= g.busiest
    print(f'{frames} frames: FT {g.ft}, {g.blocks} blocks, busiest SM '
          f'{max(per_sm)} against a mean of {mean:.1f}')
    return max(per_sm) / mean


def test_launch_geometry_balances_a_whole_chunk():
    """B = 209: the busiest SM gets at most 1.10x the mean share of
    frames."""
    assert _balance(20064) <= 1.10


def test_launch_geometry_balances_the_benchmark_chunk():
    """The benchmark's 1,667-patch chunk (160,032 frames) takes the largest
    tile, within 1.01x of the mean."""
    assert _balance(160032) <= 1.01
    assert logmel.launch_geometry(160032, 1, 132).ft == 64


def test_launch_geometry_skips_tiles_the_card_cannot_run():
    """A tile of which an SM runs no block (bz_logmel_blocks 0) is never
    taken; with none left the launch raises."""
    some = {64: 0, 32: 0, 16: 4, 8: 8}
    g = logmel.launch_geometry(160032, 1, 132, some)
    assert g.ft == 16 and g.per_sm == 4
    with pytest.raises(RuntimeError, match='fits'):
        logmel.launch_geometry(160032, 1, 132, dict.fromkeys(some, 0))


@pytest.mark.parametrize('frames,batch,sms', [(0, 1, 132), (10, 0, 132),
                                              (10, 1, 0)])
def test_launch_geometry_refuses_an_empty_launch(frames, batch, sms):
    with pytest.raises(ValueError, match='no launch'):
        logmel.launch_geometry(frames, batch, sms)


def test_wrapper_on_cpu_takes_the_plain_path():
    cfg = tfe.FrontendConfig()
    w = torch.from_numpy(_wave(16000, 7))
    np.testing.assert_array_equal(
        logmel.log_mel_spectrogram_fused(w, cfg).numpy(),
        logmel.log_mel_spectrogram_fused_plain(w, cfg).numpy())
    assert logmel.log_mel_spectrogram_fused.launches == 0


def test_wrapper_reads_the_int16_wire():
    """int16 samples are the wire, scaled by 2^-15 (as the classifier's
    ``_to_float`` and the kernel's load scale them): the same log-mel as
    the f32 samples they stand for, bit for bit."""
    cfg = tfe.FrontendConfig()
    wire = torch.from_numpy(
        np.clip(_wave(16000, 8) * 32768, -32768, 32767).astype(np.int16))
    np.testing.assert_array_equal(
        logmel.log_mel_spectrogram_fused(wire, cfg).numpy(),
        logmel.log_mel_spectrogram_fused(wire.float() / 32768, cfg).numpy())


@pytest.mark.parametrize('dtype', [torch.float32, torch.int16])
def test_paired_rows_hands_the_kernel_even_aligned_rows(dtype):
    """The kernel loads two samples at once: a padded chunk (even length,
    aligned) goes as it is; an odd length gets one zero sample more a row
    (no frame reads it); an unaligned view is copied."""
    even = torch.arange(2 * 1000).reshape(2, 1000).to(dtype)
    assert logmel._paired_rows(even) is even
    odd = torch.arange(2 * 1001).reshape(2, 1001).to(dtype)
    rows = logmel._paired_rows(odd)
    assert rows.shape == (2, 1002) and rows.is_contiguous()
    assert torch.equal(rows[:, :1001], odd) and not rows[:, 1001].any()
    view = torch.arange(1001).to(dtype)[1:].reshape(1, 1000)
    rows = logmel._paired_rows(view)
    assert torch.equal(rows, view)
    assert rows.data_ptr() % (2 * rows.element_size()) == 0


def test_wrapper_rejects_bad_inputs():
    cfg = tfe.FrontendConfig()
    with pytest.raises(ValueError, match='400 samples'):
        logmel.log_mel_spectrogram_fused(torch.zeros(399), cfg)
    with pytest.raises(ValueError, match='waveform'):
        logmel.log_mel_spectrogram_fused(torch.zeros(1, 2, 1000), cfg)
    import dataclasses
    with pytest.raises(ValueError, match='geometry'):
        logmel.log_mel_spectrogram_fused(
            torch.zeros(1000), dataclasses.replace(cfg, mel_bands=128))
    with pytest.raises(ValueError, match='unsupported device'):
        logmel.log_mel_spectrogram_fused(torch.zeros(1000, device='meta'),
                                         cfg)


@pytest.mark.parametrize('mesh', [False, True])
@pytest.mark.parametrize('device', ['cuda', 'cpu'])
@pytest.mark.parametrize('frontend', ['auto', 'xla', 'pallas'])
def test_resolve_frontend(frontend, device, mesh):
    """'auto' is the fused log-mel only on a CUDA device without a mesh;
    explicit values pass through on every device."""
    from buzzdetect_torch.models.classifier import resolve_frontend
    want = (frontend if frontend != 'auto' else
            'pallas' if device == 'cuda' and not mesh else 'xla')
    assert resolve_frontend(frontend, torch.device(device),
                            object() if mesh else None) == want


@pytest.mark.parametrize('frontend', ['tensorflow', None, 'PALLAS'])
def test_resolve_frontend_refuses_other_values(frontend):
    from buzzdetect_torch.models.classifier import resolve_frontend
    with pytest.raises(ValueError, match='frontend'):
        resolve_frontend(frontend, 'cuda')


@pytest.mark.parametrize('dtype,frontend,direct,raw', [
    (torch.int16, 'pallas', True, True),
    (torch.float32, 'pallas', True, True),
    (torch.int16, 'pallas', False, False),   # resampled first
    (torch.int16, 'xla', True, False),
    (torch.int8, 'pallas', True, False),     # mu-law: expanded first
])
def test_frontend_input_hands_the_int16_wire_to_the_kernel(dtype, frontend,
                                                           direct, raw):
    """The fused log-mel takes the int16 wire as it came (no _to_float
    pass on the card); mu-law, the resampler and the matmul frontend take
    _to_float's f32."""
    from buzzdetect_torch.models import classifier
    wire = torch.arange(-800, 800, dtype=torch.float32).to(dtype)
    got = classifier._frontend_input(wire, frontend, direct)
    assert (got is wire) == raw
    if not raw:
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, classifier._to_float(wire),
                                   rtol=0, atol=0)


@pytest.fixture(scope='module')
def bundle():
    with np.load(BUNDLE) as z:
        return {k: z[k] for k in z.files}


def test_classifier_pallas_frontend_matches_jax(bundle):
    """ChunkClassifier(frontend='pallas') on the real bundle, single chunk
    and batch path, against the JAX package's (interpret mode)."""
    jclf = JaxClassifier(bundle, frontend='pallas')
    tclf = ChunkClassifier(bundle, device='cpu', frontend='pallas')
    assert tclf.frontend == 'pallas'
    wav = _wave(int(6.3 * 16000), 11)
    wavs = [_wave(int(s * 16000), i) for i, s in enumerate((4.0, 2.7))]
    with pltpu.force_tpu_interpret_mode():
        ref = jclf.predict(wav)
        ref_b, ref_n = jclf.predict_async_batch(wavs)
    got = tclf.predict(wav)
    got_b, got_n = tclf.predict_async_batch(wavs)
    assert got.shape == ref.shape and got_n == ref_n
    err = float(np.abs(got - ref).max())
    print(f'pallas frontend, one chunk: max |dscore| = {err:.3g}')
    assert err <= ATOL_SCORE
    ref_b, got_b = np.asarray(ref_b), got_b.numpy()
    for i, n in enumerate(got_n):
        err = float(np.abs(got_b[i, :n] - ref_b[i, :n]).max())
        print(f'pallas frontend, batch row {i}: max |dscore| = {err:.3g}')
        assert err <= ATOL_SCORE


def test_classifier_pallas_frontend_goes_through_the_fused_path(bundle,
                                                                monkeypatch):
    """frontend='pallas' reaches ops/logmel.py on both paths; the matmul
    frontend is not called (no silent substitution)."""
    from buzzdetect_torch.models import classifier as tclf_mod
    calls = []
    real = logmel.log_mel_spectrogram_fused

    def spy(w, cfg):
        calls.append(tuple(w.shape))
        return real(w, cfg)

    def forbidden(*a, **k):
        raise AssertionError('the matmul frontend ran under pallas')
    monkeypatch.setattr(tclf_mod.logmel, 'log_mel_spectrogram_fused', spy)
    monkeypatch.setattr(tclf_mod, 'log_mel_patches', forbidden)
    clf = ChunkClassifier(bundle, device='cpu', frontend='pallas')
    clf.predict(_wave(20000, 1))
    clf.predict_async_batch([_wave(20000, 2), _wave(17000, 3)])
    clf.embed(_wave(20000, 4))
    assert [len(s) for s in calls] == [1, 2, 1]
