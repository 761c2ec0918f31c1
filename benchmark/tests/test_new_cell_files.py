"""A configuration, a traffic mix, a cell and a metric added as new files,
with no edit to a file that is there, run end to end (a rehearsal); and a
configuration of another architecture, with its own plain reference and
``rehearsal``, likewise."""

import json
import os
import shutil

from benchmark import checks, control
from benchmark.tests.helpers import (altered, break_path, half_left_out,
                                     rehearse)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# a reference module of another architecture: YAMNet's maths, each call
# recorded in the file ``calls``
OTHER_REFERENCE = '''"""A throwaway second architecture's plain reference."""

from benchmark.reference import yamnet


def scores(config, inputs, device, precision):
    with open({calls!r}, 'a') as f:
        f.write(f'{{config["model"]}} {{precision}} {{len(inputs)}}\\n')
    return yamnet.scores(config, inputs, device, precision)
'''


def _checkout(tmp_path):
    """A throwaway checkout: the benchmark folder copied, the bundles
    linked. Returns (root, BENCHMARK.json, {path: bytes} of every file in
    the benchmark folder)."""
    root = tmp_path / 'checkout'
    shutil.copytree(os.path.join(ROOT, 'benchmark'), root / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    (root / 'models').symlink_to(os.path.join(ROOT, 'models'))
    before = {p: open(p, 'rb').read() for p in map(str, (
        root / 'benchmark').rglob('*')) if os.path.isfile(p)}
    spec = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))
    return root, spec, before


def _unchanged(before):
    for path, data in before.items():
        assert open(path, 'rb').read() == data, path


def _throwaway_root(tmp_path):
    root, spec, before = _checkout(tmp_path)
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
    _unchanged(before)


def other_architecture(root, spec, calls):
    """Add, as new files under ``root``, a configuration that names its own
    plain reference (``reference/other_arch.py``, which records each call in
    ``calls``) and a ``rehearsal`` bundle, and the cell ``other.pinned``
    with metrics of its own."""
    bench = root / 'benchmark'
    (bench / 'reference' / 'other_arch.py').write_text(
        OTHER_REFERENCE.format(calls=str(calls)))
    cfg = json.load(open(os.path.join(ROOT, spec['configs'][0]['file'])))
    for key in ('frontend', 'conv', 'conv_precision', 'sizes'):
        del cfg[key]
    # the chip would load the architecture's own bundle; a rehearsal, a
    # tiny one (here YAMNet's, which the reference above also reads)
    cfg.update(reference='other_arch', model='other_arch_full',
               rehearsal={'model': 'model_general_v3'})
    (bench / 'configs' / 'other_arch.f32.json').write_text(json.dumps(cfg))
    (bench / 'workloads' / 'other.pinned.json').write_text(json.dumps(
        {'config': 'other_arch.f32', 'traffic': 'pinned_stream',
         'limits': {'score_gap': 3e-4}}))
    spec['configs'].append({'name': 'other_arch.f32',
                            'source': 'https://x.org',
                            'file': 'benchmark/configs/other_arch.f32.json',
                            'reduced': [], 'why': 'a throwaway'})
    spec['workloads'].append({'name': 'other.pinned',
                              'config': 'other_arch.f32',
                              'traffic': 'pinned_stream', 'chips': 1,
                              'why': 'a throwaway'})
    spec['end_to_end'].append({'name': 'stream_rtf.other',
                               'unit': 'audio_s/s', 'better': 'higher',
                               'bound': 0.02,
                               'source': 'host_clock',
                               'workloads': ['other.pinned']})
    spec['per_layer'].append({'name': 'dispatch.host_ms.stream.other',
                              'unit': 'ms', 'better': 'lower',
                              'source': 'host_clock', 'layer': 'model step',
                              'moves': 'stream_rtf.other',
                              'workloads': ['other.pinned']})
    (root / 'BENCHMARK.json').write_text(json.dumps(spec))


def test_a_cell_of_another_architecture_from_new_files(tmp_path, capsys,
                                                        monkeypatch):
    root, spec, before = _checkout(tmp_path)
    calls = tmp_path / 'calls'
    other_architecture(root, spec, calls)
    root = str(root)
    loaded = []
    load = checks.load_module

    def spy(path, name):
        loaded.append(os.path.basename(path))
        return load(path, name)
    monkeypatch.setattr(checks, 'load_module', spy)

    result = rehearse(capsys, 'other.pinned', seconds=1.0, root=root)
    assert result['correct'] and result['attempted'] > 0
    assert set(result['host_numbers']) == {'setup_s', 'stream_rtf.other'}
    traced = rehearse(capsys, 'other.pinned', seconds=1.0, trace=1,
                      root=root)
    assert traced['correct']
    assert traced['host_numbers']['dispatch.host_ms.stream.other'][
        'value'] > 0
    assert control.main(['--workload', 'other.pinned', '--seeds', '7',
                         '--rehearse'], root=root) == 0
    assert 'program correct' in capsys.readouterr().out
    for fault in (altered, half_left_out):
        with monkeypatch.context() as m:
            break_path(m, fault)
            assert rehearse(capsys, 'other.pinned', seconds=1.0,
                            root=root)['correct'] is False

    # every reference the harness loaded was the new module, with the
    # rehearsal's bundle merged in: the run's checks, the control's two
    # readings, each fault's check
    assert loaded and set(loaded) == {'other_arch.py'}
    recorded = calls.read_text().splitlines()
    assert len(recorded) == len(loaded) == 6
    assert all(ln.startswith('model_general_v3 ') for ln in recorded)
    assert {ln.split()[1] for ln in recorded} == {'f32', 'tf32'}
    _unchanged(before)
