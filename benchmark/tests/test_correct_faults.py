"""A run whose timed path is broken underneath comes out not correct: an
answer altered where it is produced, and half of a batch left out with the
mean of the rest in its place. (One chip, inference only: no state to
leave unchanged and no exchange between chips to drop.)"""

import json
import os

import pytest

from benchmark.tests.helpers import rehearse

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = [w['name'] for w in json.load(open(os.path.join(
    ROOT, 'BENCHMARK.json')))['workloads']]


def _altered(out):
    out = out.clone()
    out.view(-1)[out.numel() // 2] += 1.0
    return out


def _half_left_out(out):
    out = out.clone()
    rows = out.reshape(-1, out.shape[-1])
    keep = max(1, len(rows) // 2)
    rows[keep:] = rows[:keep].mean(dim=0)
    return out


@pytest.mark.parametrize('fault', [_altered, _half_left_out])
@pytest.mark.parametrize('workload', CELLS)
def test_a_broken_path_is_not_correct(monkeypatch, capsys, workload, fault):
    from buzzdetect_torch.models.classifier import ChunkClassifier
    original = ChunkClassifier._classify

    def broken(self, wavs, resample_args=None):
        return fault(original(self, wavs, resample_args))
    monkeypatch.setattr(ChunkClassifier, '_classify', broken)
    result = rehearse(capsys, workload, seconds=1.5)
    assert result['correct'] is False


@pytest.mark.parametrize('workload', CELLS)
def test_a_sound_path_is_correct(capsys, workload):
    result = rehearse(capsys, workload, seconds=1.5)
    assert result['correct'] is True
    assert result['attempted'] > 0 and result['failed'] == 0
