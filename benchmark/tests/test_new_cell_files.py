"""A configuration, a traffic mix, a cell and a metric added as new files,
with no edit to a file that is there, run end to end (a rehearsal)."""

import json
import os
import shutil

from benchmark.tests.helpers import rehearse

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _throwaway_root(tmp_path):
    root = tmp_path / 'checkout'
    shutil.copytree(os.path.join(ROOT, 'benchmark'), root / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    before = {p: open(p, 'rb').read() for p in map(str, (
        root / 'benchmark').rglob('*')) if os.path.isfile(p)}
    spec = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))
    cfg = json.load(open(os.path.join(ROOT, spec['configs'][0]['file'])))
    cfg['host_threads'] = 2
    (root / 'benchmark' / 'configs' / 'tiny.f32.json').write_text(
        json.dumps(cfg))
    (root / 'benchmark' / 'traffic' / 'burst_tiny.json').write_text(
        json.dumps({'generator': 'chunks', 'entry': 'closed_loop',
                    'params': {'chunks': 3, 'chunk_seconds': 1.5,
                               'dispatchers': 1, 'in_flight': 3,
                               'trace_after': 0.1, 'trace_lead': 0.1,
                               'trace_seconds': 0.3}}))
    (root / 'benchmark' / 'workloads' / 'tiny.burst.json').write_text(
        json.dumps({'config': 'tiny.f32', 'traffic': 'burst_tiny',
                    'limits': {'score_gap': 3e-4}}))
    (root / 'benchmark' / 'metrics' / 'tiny.dispatches.py').write_text(
        'def read(run):\n    return run.outcome["attempted"]\n')
    spec['configs'].append({'name': 'tiny.f32', 'source': 'https://x.org',
                            'file': 'benchmark/configs/tiny.f32.json',
                            'reduced': [], 'why': 'a throwaway'})
    spec['workloads'].append({'name': 'tiny.burst', 'config': 'tiny.f32',
                              'traffic': 'burst_tiny', 'chips': 1,
                              'why': 'a throwaway'})
    for m in spec['end_to_end']:
        if m['name'] == 'stream_rtf':
            m['workloads'].append('tiny.burst')
    spec['per_layer'].append({'name': 'tiny.dispatches', 'unit': 'chunks',
                              'better': 'higher', 'source': 'host_clock',
                              'layer': 'load generator',
                              'moves': 'stream_rtf',
                              'workloads': ['tiny.burst']})
    (root / 'BENCHMARK.json').write_text(json.dumps(spec))
    return str(root), before


def test_a_cell_from_new_files_runs(tmp_path, capsys):
    root, before = _throwaway_root(tmp_path)
    result = rehearse(capsys, 'tiny.burst', seconds=1.0, root=root)
    assert result['correct']
    assert set(result['host_numbers']) == {'setup_s', 'stream_rtf'}
    traced = rehearse(capsys, 'tiny.burst', seconds=1.0, trace=1, root=root)
    assert traced['host_numbers']['tiny.dispatches']['value'] > 0
    for path, data in before.items():
        assert open(path, 'rb').read() == data, path
