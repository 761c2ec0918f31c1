"""A run whose timed path is broken underneath comes out not correct: an
answer altered where it is produced, and half of a batch left out with the
mean of the rest in its place, each done to the scores the program hands
the harness (``helpers.break_path``), whatever the architecture. (One chip,
inference only: no state to leave unchanged and no exchange between chips
to drop.)"""

import json
import os

import pytest

from benchmark.tests.helpers import (altered, break_path, half_left_out,
                                     rehearse)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = [w['name'] for w in json.load(open(os.path.join(
    ROOT, 'BENCHMARK.json')))['workloads']]


@pytest.mark.parametrize('fault', [altered, half_left_out],
                         ids=['_altered', '_half_left_out'])
@pytest.mark.parametrize('workload', CELLS)
def test_a_broken_path_is_not_correct(monkeypatch, capsys, workload, fault):
    break_path(monkeypatch, fault)
    result = rehearse(capsys, workload, seconds=1.5)
    assert result['correct'] is False


@pytest.mark.parametrize('workload', CELLS)
def test_a_sound_path_is_correct(capsys, workload):
    result = rehearse(capsys, workload, seconds=1.5)
    assert result['correct'] is True
    assert result['attempted'] > 0 and result['failed'] == 0
