"""One short run of every cell on the card (skips without one)."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.tests.helpers import card  # noqa: F401 (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = [w['name'] for w in json.load(open(os.path.join(
    ROOT, 'BENCHMARK.json')))['workloads']]


@pytest.mark.card
@pytest.mark.parametrize('trace', [0, 1])
@pytest.mark.parametrize('workload', CELLS)
def test_a_short_run_is_correct(card, workload, trace):  # noqa: F811
    out = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', workload,
         '--seed', '4294967377', '--seconds', '12', '--trace', str(trace)],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result['correct'] and result['device']['platform'] == 'gpu'
    assert result['metrics']
    assert list(result)[-1] == 'checks'
