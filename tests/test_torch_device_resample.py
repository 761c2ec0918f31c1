"""On-device resampling in the port against the JAX package: native-rate
wire samples resampled to the model rate on the model's device
(``ChunkClassifier.predict(input_rate=)``, ``analyze(resample_on_device=
True)``), and the default host-resampling ``analyze()`` on the same
non-16 kHz files.

The classifier tests share seeded weights (``init_raw_params(seed=5)`` and
a 4-class head), handed to both packages as numpy; the analyze() tests run
the real model_general_v3 bundle. The port runs with device='cpu' (its
plain versions), the JAX side on its CPU backend.
"""

import csv
import os

import numpy as np
import pytest

import buzzdetect_tpu
import buzzdetect_torch
from buzzdetect_tpu.models import yamnet as jyam
from buzzdetect_tpu.models.classifier import ChunkClassifier as JaxClassifier
from buzzdetect_tpu.models.heads import init_head
from buzzdetect_torch.audio import ffi
from buzzdetect_torch.models.classifier import ChunkClassifier
from tests.audio_fixtures import make_tone, write_wav
from tests.test_torch_cli import _main

MODEL = 'model_general_v3'
CHUNK = 5.0       # 4.8 s: several chunks per file, with a ragged last one
ATOL_SCORE = 1e-3  # the BASELINE.md parity budget
# one unit of the last printed digit: a value within f32 rounding of a
# rounding edge may print the other way
ATOL_CSV = 0.01 + 1e-9
RNG = np.random.default_rng(11)


@pytest.fixture(scope='module')
def classifiers():
    raw = jyam.init_raw_params(seed=5)
    arrays = {f'yamnet_raw/{k}': v for k, v in raw.items()}
    arrays.update(init_head(jyam.N_EMBEDDINGS, 4, seed=5))
    return (JaxClassifier(arrays, framehop_prop=1.0),
            ChunkClassifier(arrays, framehop_prop=1.0, device='cpu'))


@pytest.mark.parametrize('native', [44100, 48000, 22050, 8000])
def test_predict_input_rate_matches_jax(classifiers, native):
    jclf, tclf = classifiers
    wav = (RNG.standard_normal(int(3.3 * native)) * 0.1).astype(np.float32)
    ref = jclf.predict(wav, input_rate=native)
    got = tclf.predict(wav, input_rate=native)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    print(f'predict input_rate={native}: {got.shape}, max |dscore| = '
          f'{err:.3g}')
    assert err <= ATOL_SCORE


def test_predict_batch_input_rate_two_lengths(classifiers):
    """A batch shares one native rate; each row is masked at its own
    valid length, so it scores as the same chunk alone."""
    jclf, tclf = classifiers
    native = 32000
    wavs = [(RNG.standard_normal(int(s * native)) * 0.1).astype(np.float32)
            for s in (2.0, 3.3)]
    ref, ref_n = jclf.predict_async_batch(wavs, input_rate=native)
    got, got_n = tclf.predict_async_batch(wavs, input_rate=native)
    assert got_n == ref_n
    ref, got = np.asarray(ref), got.numpy()
    for i, n in enumerate(got_n):
        err = float(np.abs(got[i, :n] - ref[i, :n]).max())
        print(f'batch row {i}: n_valid {n}, max |dscore| = {err:.3g}')
        assert err <= ATOL_SCORE
        np.testing.assert_allclose(
            got[i, :n], tclf.predict(wavs[i], input_rate=native), atol=1e-5)


def test_input_rate_at_model_rate_is_the_identity_path(classifiers):
    _, tclf = classifiers
    wav = (RNG.standard_normal(2 * 16000) * 0.1).astype(np.float32)
    np.testing.assert_array_equal(tclf.predict(wav),
                                  tclf.predict(wav, input_rate=16000))


def test_ragged_chunk_is_zeroed_past_its_valid_length():
    """The resampled waveform is exactly zero past the chunk's model-rate
    length: without the mask the filter rings into the padding."""
    import torch
    from buzzdetect_torch.models.classifier import _resample_in_graph
    from buzzdetect_torch.ops.frontend import FrontendConfig
    cfg = FrontendConfig()
    x = torch.from_numpy(RNG.standard_normal(44100).astype(np.float32))
    padded = torch.nn.functional.pad(x, (0, 22050))
    n_model = -(-44100 * 16000 // 44100)
    y = _resample_in_graph(padded, cfg, 44100, 25000, n_model)
    assert y.shape == (25000,)
    assert bool((y[n_model:] == 0).all())
    assert float(y[n_model - 200:n_model].abs().max()) > 0
    batch = _resample_in_graph(torch.stack([padded, padded]), cfg, 44100,
                               25000, torch.tensor([[n_model], [8000]]))
    assert bool((batch[1, 8000:] == 0).all())
    np.testing.assert_array_equal(batch[0].numpy(), y.numpy())


# --- analyze() end to end ---------------------------------------------------

@pytest.fixture(scope='module')
def audio(tmp_path_factory):
    root = tmp_path_factory.mktemp('native_rates')
    rng = np.random.default_rng(3)
    write_wav(root / 'tone44k.wav',
              make_tone(11.3, 44100, 440)
              + (rng.standard_normal(int(11.3 * 44100)) * 0.02
                 ).astype(np.float32)[:int(11.3 * 44100)], 44100)
    n = int(8.7 * 48000)
    write_wav(root / 'stereo48k.wav',
              np.stack([make_tone(8.7, 48000, 520)[:n],
                        (rng.standard_normal(n) * 0.1).astype(np.float32)],
                       1), 48000)
    ffi.encode_fixture(str(root / 'fixture48k.flac'), 'flac', 48000, 1, 6.1)
    return str(root)


NAMES = ['fixture48k_buzzdetect.csv', 'stereo48k_buzzdetect.csv',
         'tone44k_buzzdetect.csv']


def _results(dir_out):
    found = {}
    for f in sorted(os.listdir(dir_out)):
        if f.endswith('_buzzdetect.csv'):
            with open(os.path.join(dir_out, f)) as fh:
                found[f] = list(csv.reader(fh))
    return found


@pytest.fixture(scope='module')
def runs(audio, tmp_path_factory):
    """(package, resample_on_device) -> the CSVs of one analyze() run,
    made on first use."""
    root = tmp_path_factory.mktemp('runs')
    done = {}

    def get(pkg, on_device):
        key = (pkg.__name__, on_device)
        if key not in done:
            dir_out = root / f'{key[0]}_{int(on_device)}'
            extra = {'device': 'cpu'} if pkg is buzzdetect_torch else {}
            a = pkg.analyze(modelname=MODEL, dir_audio=audio,
                            dir_out=str(dir_out), chunklength=CHUNK,
                            verbosity_print='ERROR',
                            resample_on_device=on_device, **extra)
            assert a.coordinator.end_reason == 'completed'
            done[key] = (_results(str(dir_out)), str(dir_out))
        return done[key]
    return get


def _compare(port, ref, label):
    assert sorted(port) == sorted(ref) == NAMES
    worst, cells = 0.0, 0
    for name in NAMES:
        p, r = port[name], ref[name]
        assert p[0] == r[0], name
        assert len(p) == len(r), name
        assert [row[0] for row in p] == [row[0] for row in r], name
        d = np.abs(np.array(p[1:], float)[:, 1:]
                   - np.array(r[1:], float)[:, 1:])
        worst = max(worst, float(d.max()))
        cells += int((d > 0).sum())
    print(f'{label}: max |port - jax| over CSV scores = {worst:.3g} '
          f'({cells} cells differ in the last digit)')
    assert worst <= ATOL_CSV


@pytest.mark.parametrize('on_device', [True, False],
                         ids=['resample_on_device', 'host_resampling'])
def test_analyze_matches_jax(runs, on_device):
    port, _ = runs(buzzdetect_torch, on_device)
    ref, _ = runs(buzzdetect_tpu, on_device)
    # 11.3 s at 4.8 s chunks: 11 whole frames and a padded 12th
    assert len(port['tone44k_buzzdetect.csv']) - 1 == 12
    _compare(port, ref, 'resample_on_device' if on_device
             else 'host resampling')


def test_analyze_logs_the_decoder_choice(runs):
    _, dir_out = runs(buzzdetect_torch, True)
    logs = [f for f in os.listdir(dir_out) if f.endswith('.log')]
    assert logs
    with open(os.path.join(dir_out, logs[0])) as f:
        text = f.read()
    assert 'audio decode: the native libav stage' in text
    assert 'Resample on device: True' in text


def test_cli_resample_on_device_runs_to_fully_analyzed(audio, runs,
                                                       tmp_path):
    """The flag reaches analyze(): one file through the CLI gives the API
    run's CSV byte for byte; the second run finds nothing left to do."""
    _, api_out = runs(buzzdetect_torch, True)
    one = tmp_path / 'one'
    one.mkdir()
    os.symlink(os.path.join(audio, 'tone44k.wav'), one / 'tone44k.wav')
    argv = ['--modelname', MODEL, '--dir_audio', str(one), '--dir_out',
            str(tmp_path / 'out'), '--chunklength', str(CHUNK),
            '--device', 'cpu', '--resample_on_device',
            '--verbosity_print', 'ERROR']
    assert _main(argv).coordinator.end_reason == 'completed'
    got = (tmp_path / 'out' / 'tone44k_buzzdetect.csv').read_text()
    with open(os.path.join(api_out, 'tone44k_buzzdetect.csv')) as f:
        assert got == f.read()
    assert _main(argv).coordinator.end_reason == 'fully analyzed'


def test_analyze_rejects_a_model_that_cannot_resample(audio, monkeypatch,
                                                      tmp_path):
    """Plugin models receive model-rate samples: resample_on_device must
    fail fast instead of feeding them native-rate audio."""
    from buzzdetect_torch import analysis
    real_load = analysis.load_model

    def load_no_resample(*a, **k):
        m = real_load(*a, **k)
        m.supports_device_resample = False
        return m
    monkeypatch.setattr(analysis, 'load_model', load_no_resample)
    with pytest.raises(ValueError, match='resample_on_device'):
        analysis.Analyzer(modelname=MODEL, dir_audio=audio, device='cpu',
                          dir_out=str(tmp_path / 'out'),
                          resample_on_device=True)
