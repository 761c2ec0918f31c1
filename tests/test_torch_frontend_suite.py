"""tests/test_frontend.py, case for case, against ``buzzdetect_torch``
(import prefix changed, same assertions; ``test_torch_frontend.py`` holds
the port's own frontend cases). Edits: the port's frontend takes tensors,
so each numpy waveform goes in through ``torch.from_numpy`` (``_t``);
``pad_waveform`` takes either. The TF oracle and the tolerances are the JAX
cases'.

The JAX package's docstring:
Golden-parity tests: JAX log-mel frontend vs the TensorFlow signal ops the
reference pipeline is built on (`embedders/yamnet/features.py:22-108`).

BASELINE.md requires per-window scores to match the TF pipeline within 1e-3;
the frontend is the dominant parity risk, so it is tested directly against
tf.signal at tolerance 1e-3 (and the mel/window constants at much tighter
tolerances).
"""

import numpy as np
import pytest
import torch

from buzzdetect_torch.ops import mel as mel_lib
from buzzdetect_torch.ops.frontend import (
    FrontendConfig, padded_length, num_patches, pad_waveform,
    log_mel_spectrogram, log_mel_patches, min_waveform_samples)

tf = pytest.importorskip('tensorflow')

CFG = FrontendConfig()  # default: framehop 0.5 (patch_hop_seconds=0.48)
CFG_WHOLE = CFG.with_framehop(1.0)

RNG = np.random.default_rng(0)


def _t(x):
    """A numpy waveform as the tensor the port's frontend takes."""
    return torch.from_numpy(np.ascontiguousarray(x))


def _tf_log_mel(waveform, cfg):
    stft = tf.signal.stft(tf.constant(waveform, tf.float32),
                          frame_length=cfg.window_samples,
                          frame_step=cfg.hop_samples,
                          fft_length=cfg.fft_length)
    mag = tf.abs(stft)
    mel = tf.signal.linear_to_mel_weight_matrix(
        num_mel_bins=cfg.mel_bands, num_spectrogram_bins=cfg.fft_bins,
        sample_rate=cfg.sample_rate, lower_edge_hertz=cfg.mel_min_hz,
        upper_edge_hertz=cfg.mel_max_hz)
    return tf.math.log(tf.matmul(mag, mel) + cfg.log_offset).numpy()


def test_hann_window_matches_tf():
    ours = mel_lib.hann_window_periodic(400)
    theirs = tf.signal.hann_window(400, periodic=True).numpy()
    np.testing.assert_allclose(ours, theirs, atol=1e-6)


def test_mel_matrix_matches_tf():
    ours = mel_lib.mel_weight_matrix()
    theirs = tf.signal.linear_to_mel_weight_matrix(
        num_mel_bins=64, num_spectrogram_bins=257, sample_rate=16000,
        lower_edge_hertz=125.0, upper_edge_hertz=7500.0).numpy()
    # TF evaluates the matrix in float32; ours is float64-accurate
    np.testing.assert_allclose(ours, theirs, atol=2e-5)


def test_windowed_dft_matches_rfft():
    x = RNG.standard_normal(400).astype(np.float32)
    w_re, w_im = mel_lib.windowed_rdft_matrices(400, 512)
    ours = x @ w_re + 1j * (x @ w_im)
    theirs = np.fft.rfft(x * mel_lib.hann_window_periodic(400), 512)
    np.testing.assert_allclose(ours, theirs, atol=1e-3)


def test_log_mel_matches_tf_signal():
    wav = (RNG.standard_normal(3 * 16000) * 0.1).astype(np.float32)
    ours = np.asarray(log_mel_spectrogram(_t(wav), CFG))
    theirs = _tf_log_mel(wav, CFG)
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, atol=1e-3)


def test_log_mel_quiet_audio():
    # near-silence stresses the log: mel energies ~log_offset
    wav = (RNG.standard_normal(16000) * 1e-5).astype(np.float32)
    ours = np.asarray(log_mel_spectrogram(_t(wav), CFG))
    theirs = _tf_log_mel(wav, CFG)
    np.testing.assert_allclose(ours, theirs, atol=1e-3)


def _tf_padded_length(n_samples, cfg):
    """The reference two-part padding rule, recomputed independently."""
    min_samples = int((cfg.patch_window_seconds + cfg.stft_window_seconds
                       - cfg.stft_hop_seconds) * cfg.sample_rate)
    hop = int(cfg.patch_hop_seconds * cfg.sample_rate)
    n = max(n_samples, min_samples)
    extra = n - min_samples
    import math
    return min_samples + hop * math.ceil(extra / hop)


@pytest.mark.parametrize('n', [1, 100, 15360, 15600, 15601, 16000,
                               160000, 3200000])
@pytest.mark.parametrize('cfg', [CFG, CFG_WHOLE], ids=['halfhop', 'wholehop'])
def test_padded_length_rule(n, cfg):
    assert padded_length(n, cfg) == _tf_padded_length(n, cfg)


@pytest.mark.parametrize('seconds,framehop,expected_relation', [
    (0.975, 1.0, 1),      # exactly the one-patch minimum
    (10.0, 1.0, None),
    (10.0, 0.5, None),
    (50.0, 1.0, None),
])
def test_patch_count_and_framing_vs_tf(seconds, framehop, expected_relation):
    cfg = CFG.with_framehop(framehop)
    n = int(seconds * 16000)
    wav = (RNG.standard_normal(n) * 0.1).astype(np.float32)

    padded = pad_waveform(wav, cfg)
    ours = np.asarray(log_mel_patches(padded, cfg))

    # TF oracle: pad the same way, then tf.signal.frame over the log-mel
    theirs_logmel = _tf_log_mel(np.asarray(padded), cfg)
    theirs = tf.signal.frame(theirs_logmel, cfg.patch_frames,
                             cfg.patch_hop_frames, axis=0).numpy()

    assert ours.shape == theirs.shape
    assert ours.shape[0] == num_patches(n, cfg)
    if expected_relation is not None:
        assert ours.shape[0] == expected_relation
    np.testing.assert_allclose(ours, theirs, atol=1e-3)


def test_wholehop_contiguous_chunks_tile_seamlessly():
    """At framehop 1.0 a chunk whose length is a frame multiple produces
    patches that tile exactly: analyzing [0,c) and [c,2c) equals [0,2c)."""
    cfg = CFG_WHOLE
    c = int(9.6 * 16000)
    wav = (RNG.standard_normal(2 * c) * 0.1).astype(np.float32)

    both = np.asarray(log_mel_patches(pad_waveform(wav, cfg), cfg))
    first = np.asarray(log_mel_patches(pad_waveform(wav[:c], cfg), cfg))
    second = np.asarray(log_mel_patches(pad_waveform(wav[c:], cfg), cfg))

    assert first.shape[0] + second.shape[0] == both.shape[0]
    # each chunk's FINAL patch needs 240 samples (stft window - hop) of
    # lookahead past the chunk end, which chunked processing zero-pads; all
    # interior patches are bit-comparable. The reference behaves identically.
    n1 = first.shape[0]
    np.testing.assert_allclose(first[:-1], both[:n1 - 1], atol=1e-4)
    np.testing.assert_allclose(second[:-1], both[n1:-1], atol=1e-4)


def test_batched_frontend():
    wav = (RNG.standard_normal((3, 32640)) * 0.1).astype(np.float32)
    out = np.asarray(log_mel_patches(_t(wav), CFG_WHOLE))
    single = np.asarray(log_mel_patches(_t(wav[1]), CFG_WHOLE))
    assert out.shape[0] == 3
    np.testing.assert_allclose(out[1], single, atol=1e-6)


def test_framehop_one_third_hop_consistency():
    """patch_hop_samples must equal patch_hop_frames * hop_samples: a
    truncating seconds->samples conversion at framehop 1/3 landed one
    sample short of a frame boundary and silently dropped the final patch
    of every chunk."""
    cfg = FrontendConfig().with_framehop(1.0 / 3.0)
    assert cfg.patch_hop_samples == cfg.patch_hop_frames * cfg.hop_samples
    n = min_waveform_samples(cfg) + 1  # one sample past one patch
    # a consistent hop yields exactly one extra patch hop of padding
    assert (padded_length(n, cfg) - min_waveform_samples(cfg)
            == cfg.patch_hop_samples)
    assert num_patches(n, cfg) == 2


def test_framehop_below_frame_resolution_rejected():
    """A framehop finer than one spectrogram frame cannot be represented;
    it must fail with a clear error, not a ZeroDivisionError mid-run."""
    import pytest
    with pytest.raises(ValueError, match='resolution'):
        FrontendConfig().with_framehop(0.004)


def test_framehop_snaps_to_spectrogram_grid():
    """The graph extracts patches every whole 10 ms spectrogram frame;
    with_framehop must snap patch_hop_seconds to that grid so writer
    timestamps and resume coverage match the frames actually analyzed
    (prop=0.1 really strides 0.100 s, not 0.096 s)."""
    c = FrontendConfig().with_framehop(0.1)
    assert c.patch_hop_frames == 10
    assert abs(c.patch_hop_seconds - 0.10) < 1e-12
    c7 = FrontendConfig().with_framehop(0.7)
    assert c7.patch_hop_frames == 67
    assert abs(c7.patch_hop_seconds - 0.67) < 1e-12
    # grid-aligned hops are untouched
    assert abs(FrontendConfig().with_framehop(0.5).patch_hop_seconds
               - 0.48) < 1e-12
    assert abs(FrontendConfig().with_framehop(1.0).patch_hop_seconds
               - 0.96) < 1e-12


def test_embedder_metadata_matches_graph_stride():
    """The embedder's advertised framehop_s (used by the writer's timestamps
    and the streamer's resume coverage) must equal the graph's true patch
    stride, not framelength * prop."""
    from buzzdetect_torch.models.registry import EmbedderYamnet
    for prop, want in [(0.1, 0.10), (0.7, 0.67), (0.5, 0.48), (1.0, 0.96)]:
        emb = EmbedderYamnet(framehop_prop=prop)
        assert abs(emb.framehop_s - want) < 1e-12, (prop, emb.framehop_s)


def test_sparse_framehop_no_phantom_tail_patch():
    """At framehop > 1 the patch hop exceeds the patch window; the padding
    round-up must not fabricate a final patch of 100% zero padding (a
    result row timestamped past the file's end) while the real tail
    samples fall in no patch's start."""
    from buzzdetect_torch.ops.frontend import num_patches, padded_length
    c = FrontendConfig().with_framehop(2.0)
    n = 16000  # 1.0 s file
    assert num_patches(n, c) == 1  # patch 2 would start at 1.92 s: phantom
    # the padded shape may still frame the phantom — n_valid slices it off
    # as ordinary shape padding — but must never truncate real samples
    assert padded_length(n, c) >= n
    # a file long enough for a real second patch still gets it
    assert num_patches(2 * c.patch_hop_samples, c) == 2


def test_num_patches_parity_preserved_for_dense_framehops():
    """The phantom-tail cap must never change patch counts in the TF-parity
    regime (framehop <= 1)."""
    from buzzdetect_torch.ops.frontend import num_patches, padded_length
    for prop in (1.0, 0.5, 1.0 / 3.0, 0.1):
        c = FrontendConfig().with_framehop(prop)
        for n in (15600, 15601, 16000, 32000, 160000, 3194880):
            hop = c.patch_hop_samples
            extra = max(0, n - 15600)
            want = 1 + int(np.ceil(extra / hop))  # reference round-up rule
            assert num_patches(n, c) == want, (prop, n)
            frames = 1 + (padded_length(n, c)
                          - c.window_samples) // c.hop_samples
            assert 1 + (frames - c.patch_frames) // c.patch_hop_frames == want


def test_framehop_one_reshape_framing_matches_gather():
    """At framehop 1.0 patch framing takes a trim+reshape fast path; it must
    emit exactly what the general gather formulation emits."""
    from buzzdetect_torch.ops.frontend import (FrontendConfig,
                                               patches_from_log_mel,
                                               _frame_indices)
    import numpy as np

    cfg = FrontendConfig().with_framehop(1.0)
    rng = np.random.default_rng(17)
    for n_frames in (96, 96 * 3, 96 * 3 + 41):  # exact tiles + a remainder
        log_mel = rng.standard_normal((n_frames, 64)).astype(np.float32)
        got = np.asarray(patches_from_log_mel(_t(log_mel), cfg))
        idx = _frame_indices(n_frames, cfg.patch_frames,
                             cfg.patch_hop_frames)
        np.testing.assert_array_equal(got, log_mel[np.asarray(idx)])
        # batched leading dim takes the same path
        got_b = np.asarray(patches_from_log_mel(_t(log_mel[None]), cfg))
        np.testing.assert_array_equal(got_b[0], got)
