"""tests/test_pallas.py, case for case, against ``buzzdetect_torch`` (import
prefix changed, same assertions, every run on the CPU). Edits:

* the log-mel kernel function is ``ops/logmel.log_mel_spectrogram_fused``;
  on a CPU tensor its wrapper runs the plain version. Each case also runs
  the JAX case's own Pallas function (interpret mode) on the same numpy
  input, prints max |port - JAX| and holds it to the JAX case's tolerance;
* ``frontend='pallas'`` off a TPU: the JAX package cannot compile the
  kernel on the CPU and raises; the port runs the plain log-mel on the CPU
  and the kernel on the card, and never the matmul frontend in its place.
  The twins check that the fused function is what runs (a spy counts its
  calls: one per batch on the batch path) and that asking for the card
  without one raises.

The JAX package's docstring:

Pallas fused frontend: parity with the XLA frontend (interpreter mode on
the CPU test mesh; compiled mode on real TPU via bench).
"""

import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from buzzdetect_torch.ops import logmel
from buzzdetect_torch.ops.frontend import (FrontendConfig, pad_waveform,
                                           log_mel_spectrogram)

RNG = np.random.default_rng(5)


def _against_jax(name, got, ref, atol):
    got, ref = np.asarray(got), np.asarray(ref)
    print(f'{name}: max |port - JAX| = {np.abs(got - ref).max():.3g}')
    np.testing.assert_allclose(got, ref, atol=atol)


def _count_fused(monkeypatch):
    """Count the classifier's calls of the fused log-mel wrapper."""
    calls = []
    real = logmel.log_mel_spectrogram_fused

    def spy(waveform, cfg):
        calls.append(tuple(waveform.shape))
        return real(waveform, cfg)
    monkeypatch.setattr(logmel, 'log_mel_spectrogram_fused', spy)
    return calls


@pytest.mark.parametrize('seconds', [1.0, 4.8, 10.0])
def test_pallas_matches_xla_frontend(seconds):
    from buzzdetect_tpu.ops import frontend as jfe
    from buzzdetect_tpu.ops.pallas_frontend import log_mel_spectrogram_pallas
    cfg = FrontendConfig().with_framehop(1.0)
    wav = (RNG.standard_normal(int(seconds * 16000)) * 0.1).astype(np.float32)
    padded = pad_waveform(wav, cfg)

    xla = np.asarray(log_mel_spectrogram(padded, cfg))
    pallas = np.asarray(logmel.log_mel_spectrogram_fused(padded, cfg))

    assert pallas.shape == xla.shape
    np.testing.assert_allclose(pallas, xla, atol=2e-4)
    with pltpu.force_tpu_interpret_mode():
        ref = log_mel_spectrogram_pallas(
            jfe.pad_waveform(wav, jfe.FrontendConfig().with_framehop(1.0)),
            jfe.FrontendConfig().with_framehop(1.0))
    _against_jax(f'log_mel {seconds} s', pallas, ref, 2e-4)


def test_classifier_pallas_frontend_matches_xla():
    """ChunkClassifier(frontend='pallas') produces the same scores as the
    default matmul frontend (the plain log-mel on the CPU), and as the JAX
    classifier's frontend='pallas' (interpret mode)."""
    from buzzdetect_tpu.models.classifier import ChunkClassifier as JClf
    from buzzdetect_torch.models import yamnet as yam
    from buzzdetect_torch.models.classifier import ChunkClassifier
    from buzzdetect_torch.models.heads import init_head

    folded = yam.fold_batchnorm(yam.init_raw_params(seed=6))
    arrays = {f'yamnet/{k}': v for k, v in folded.items()}
    arrays.update(init_head(1024, 3, seed=6))

    wav = (RNG.standard_normal(int(3.0 * 16000)) * 0.1).astype(np.float32)
    xla_out = ChunkClassifier(arrays, framehop_prop=1.0,
                              device='cpu').predict(wav)
    pl_out = ChunkClassifier(arrays, framehop_prop=1.0, frontend='pallas',
                             device='cpu').predict(wav)
    np.testing.assert_allclose(pl_out, xla_out, atol=1e-3)
    with pltpu.force_tpu_interpret_mode():
        ref = JClf(arrays, framehop_prop=1.0, frontend='pallas').predict(wav)
    _against_jax('classifier frontend=pallas', pl_out, ref, 1e-3)


def test_classifier_pallas_frontend_batch_path(monkeypatch):
    """frontend='pallas' must also run the fused log-mel on the BATCH
    dispatch path (predict_async_batch): one call of the fused function for
    the batch, never the matmul frontend in its place. Verified by score
    parity with the matmul frontend, by the spy's count, and by the loud
    failure of a classifier on the card where there is none."""
    from buzzdetect_torch.models.classifier import ChunkClassifier

    arrays = _tiny_arrays()
    wavs = [(RNG.standard_normal(int(s * 16000)) * 0.1).astype(np.float32)
            for s in (2.0, 3.0)]
    xla_clf = ChunkClassifier(arrays, framehop_prop=1.0, device='cpu')
    xla_out, xla_valid = xla_clf.predict_async_batch(wavs)
    pl_clf = ChunkClassifier(arrays, framehop_prop=1.0, frontend='pallas',
                             device='cpu')
    calls = _count_fused(monkeypatch)
    pl_out, pl_valid = pl_clf.predict_async_batch(wavs)
    assert len(calls) == 1 and len(calls[0]) == 2   # one (B, L) call
    assert pl_valid == xla_valid
    np.testing.assert_allclose(np.asarray(pl_out.cpu()),
                               np.asarray(xla_out.cpu()), atol=1e-3)

    # without a card the explicit choice on the card fails loudly
    with pytest.raises(Exception):
        strict = ChunkClassifier(arrays, frontend='pallas')
        strict.predict_async_batch(wavs)


def _tiny_arrays(seed=6, n_classes=3):
    from buzzdetect_torch.models import yamnet as yam
    from buzzdetect_torch.models.heads import init_head
    folded = yam.fold_batchnorm(yam.init_raw_params(seed=seed))
    arrays = {f'yamnet/{k}': v for k, v in folded.items()}
    arrays.update(init_head(1024, n_classes, seed=seed))
    return arrays


def test_frontend_auto_resolves_to_banked_xla():
    """On the CPU 'auto' (the default) resolves to the hop-banked matmul
    frontend, as in the JAX package; the rule is per device
    (``classifier.resolve_frontend``: the fused log-mel on a CUDA device
    without a mesh). 'auto' stays the default name so resolution can be
    re-tuned per backend without touching callers."""
    from buzzdetect_torch.models.classifier import ChunkClassifier
    clf = ChunkClassifier(_tiny_arrays(), device='cpu')
    assert clf.frontend == 'xla'
    assert clf._frontend_auto

    with pytest.raises(ValueError):
        ChunkClassifier(_tiny_arrays(), frontend='tensorflow', device='cpu')


def test_frontend_explicit_pallas_fails_loudly_off_tpu(monkeypatch):
    """An EXPLICIT pallas request must never silently substitute another
    frontend: on the CPU the port runs the fused log-mel's plain version
    (the spy sees it), and on a card that is not there it raises."""
    from buzzdetect_torch.models.classifier import ChunkClassifier
    wav = (RNG.standard_normal(int(2.0 * 16000)) * 0.1).astype(np.float32)
    strict = ChunkClassifier(_tiny_arrays(), frontend='pallas', device='cpu')
    assert not strict._frontend_auto
    calls = _count_fused(monkeypatch)
    strict.predict(wav)
    assert len(calls) == 1
    with pytest.raises(Exception):
        ChunkClassifier(_tiny_arrays(), frontend='pallas').predict(wav)
    assert strict.frontend == 'pallas'
