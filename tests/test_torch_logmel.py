"""The port's fused log-mel (ops/logmel.py) against the Pallas frontend.

The plain version runs here, on the CPU; the JAX side runs
``log_mel_spectrogram_pallas`` in interpret mode, as tests/test_pallas.py
does. The CUDA kernel itself is held against the plain version on the card
by chip_smoke.py; here its operand layout is checked by rebuilding the DFT
from the operands the kernel reads.
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


def test_kernel_operands_rebuild_the_dft():
    """The kernel reads the DFT as 4 chunks of [re | im] for 64 bins plus
    bin 256 apart; put back together they are the plain version's
    (400, 514) matrix, column for column."""
    cfg = tfe.FrontendConfig()
    ops = logmel._operands(cfg, torch.device('cpu'))
    chunks, nyq, dft = ops['chunks'], ops['nyq'], ops['dft']
    c = logmel.BINS_PER_CHUNK
    assert tuple(chunks.shape) == (4, 400, 2 * c)
    assert tuple(nyq.shape) == (400, 2)
    assert tuple(ops['mel'].shape) == (257, 64)
    re = torch.cat([chunks[i, :, :c] for i in range(4)] + [nyq[:, :1]], 1)
    im = torch.cat([chunks[i, :, c:] for i in range(4)] + [nyq[:, 1:]], 1)
    torch.testing.assert_close(torch.cat([re, im], 1), dft, rtol=0, atol=0)
    # the constants are the matmul frontend's: the same windowed DFT
    banks, mel = tfe._dft_mel_constants_np(400, 512, 160, 64, 257, 16000,
                                           125.0, 7500.0)
    np.testing.assert_array_equal(banks.reshape(-1, 514)[:400], dft.numpy())
    np.testing.assert_array_equal(mel, ops['mel'].numpy())


# (frames per waveform, batch): one 200 s chunk (B = 209 patches), a file's
# ragged last chunk (B = 5), and ragged counts around the frame tiles
GEOMETRY_CASES = [(20064, 1), (480, 1)] + [
    (frames, batch) for frames in (1, 63, 65, 4097) for batch in (1, 3)]


@pytest.mark.parametrize('sms', [132, 8])
@pytest.mark.parametrize('frames,batch', GEOMETRY_CASES)
def test_launch_geometry_covers_every_frame_once(frames, batch, sms):
    """Every (batch row, frame) is one cluster's: each of its 4 bin chunks
    owned by one rank of that cluster, each of its 64 mel bands by one
    block, and the grid holds whole clusters."""
    g = logmel.launch_geometry(frames, batch, sms)
    assert g.ft in logmel.FRAME_TILES and g.cs in logmel.CLUSTER_SIZES
    assert g.grid[0] % g.cs == 0 and g.grid[1] == batch
    assert g.blocks == g.grid[0] * g.grid[1]
    chunks = np.zeros((batch, frames, logmel.N_CHUNKS), int)
    bands = np.zeros((batch, frames, logmel.MELS), int)
    cluster_of = np.full((batch, frames), -1)
    for by in range(g.grid[1]):
        for bx in range(g.grid[0]):
            row, fr, ch, bd = logmel.block_work(g, frames, bx, by)
            assert row == by
            assert len(ch) == logmel.N_CHUNKS // g.cs
            assert len(bd) == logmel.MELS // g.cs
            for f in fr:
                chunks[row, f, ch.start:ch.stop] += 1
                bands[row, f, bd.start:bd.stop] += 1
                assert cluster_of[row, f] in (-1, bx // g.cs)
                cluster_of[row, f] = bx // g.cs
    assert (chunks == 1).all() and (bands == 1).all()
    assert (cluster_of >= 0).all()


def test_launch_geometry_fills_the_card_for_a_ragged_last_chunk():
    """B = 5 (480 frames) was 8 blocks on 132 SMs; now at least 60."""
    g = logmel.launch_geometry(480, 1, 132)
    assert g.blocks >= 60
    print(f'B=5: FT {g.ft}, CS {g.cs}, {g.blocks} blocks')


def test_launch_geometry_balances_a_whole_chunk():
    """B = 209: the busiest SM gets at most 1.10x the mean share of
    (frame, bin-chunk) pairs, counted from the grid itself."""
    frames, sms = 20064, 132
    g = logmel.launch_geometry(frames, 1, sms)
    pairs = [len(fr) * len(ch) for _row, fr, ch, _bd in
             (logmel.block_work(g, frames, bx, 0) for bx in range(g.grid[0]))]
    # blocks dealt to the SMs in turn, as the card fills a wave
    per_sm = [sum(pairs[i::sms]) for i in range(sms)]
    mean = frames * logmel.N_CHUNKS / sms
    assert mean == g.mean and max(per_sm) <= g.busiest
    print(f'B=209: FT {g.ft}, CS {g.cs}, {g.blocks} blocks, busiest SM '
          f'{max(per_sm)} against a mean of {mean:.1f}')
    assert max(per_sm) <= 1.10 * mean


def test_launch_geometry_takes_clusters_of_two_where_four_fill_fewer_sms():
    """When the card runs few clusters of 4 at once (SMs of a GPC left
    over), clusters of 2 fill more SMs and are taken; a geometry the card
    cannot run at all (0 clusters) never is."""
    few_fours = {(ft, cs): 16 if cs == 4 else 66
                 for ft in logmel.FRAME_TILES for cs in logmel.CLUSTER_SIZES}
    g = logmel.launch_geometry(20064, 1, 132, few_fours)
    assert g.cs == 2 and g.clusters == 66
    only_small = {(ft, cs): 0 if ft > 32 else 66
                  for ft in logmel.FRAME_TILES for cs in logmel.CLUSTER_SIZES}
    assert logmel.launch_geometry(20064, 1, 132, only_small).ft == 32
    with pytest.raises(RuntimeError, match='fits'):
        logmel.launch_geometry(20064, 1, 132, dict.fromkeys(few_fours, 0))


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
