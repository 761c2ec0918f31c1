"""Each cell's control comes out not correct, and the program correct, when
both go through the run's own checks with the cell's limits, on the cell's
own path at the rehearsal sizes (the chip runs the same at the cells' own
sizes: ``python3 benchmark/control.py --workload <cell> --seeds ...``)."""

import json
import os

import pytest

from benchmark import control

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELLS = [w['name'] for w in json.load(open(os.path.join(
    ROOT, 'BENCHMARK.json')))['workloads']]


@pytest.mark.parametrize('workload', CELLS)
def test_control_fails_and_program_passes(capsys, workload):
    assert control.main(['--workload', workload, '--seeds', '7,8',
                         '--rehearse']) == 0
    out = capsys.readouterr().out
    assert out.count('control (') == 2
    assert 'control (tf32) not correct' in out \
        or 'control (fp8) not correct' in out
    assert 'program correct' in out
