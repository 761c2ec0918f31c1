"""BENCHMARK.json against the rules the benchmark is held to."""

import json
import os
import re

import pytest

from benchmark.manifest import NAME, SOURCES, UNIT, Benchmark, reference_of

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SPEC = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))
KEYS = {'configs': {'name', 'source', 'file', 'reduced', 'why'},
        'workloads': {'name', 'config', 'traffic', 'chips', 'why'},
        'end_to_end': {'name', 'unit', 'better', 'bound', 'source'},
        'per_layer': {'name', 'unit', 'better', 'source', 'layer', 'moves'}}


def test_top_level_keys_and_command():
    assert set(SPEC) == {'command', 'paths', 'run_seconds', 'configs',
                         'workloads', 'end_to_end', 'per_layer'}
    assert SPEC['paths'] == ['benchmark']
    assert 1 <= len(SPEC['command']) <= 32
    for word in SPEC['command']:
        assert not word.startswith('/') and '..' not in word
    assert os.path.isfile(os.path.join(ROOT, SPEC['command'][1]))
    assert isinstance(SPEC['run_seconds'], int)
    assert 1 <= SPEC['run_seconds'] <= 51


@pytest.mark.parametrize('group', sorted(KEYS))
def test_entries_keys_and_names(group):
    names = [e['name'] for e in SPEC[group]]
    assert len(names) == len(set(names))
    for e in SPEC[group]:
        extra = {'workloads'} if group in ('end_to_end', 'per_layer') \
            else set()
        assert KEYS[group] <= set(e) <= KEYS[group] | extra, e['name']
        assert NAME.match(e['name']), e['name']
        for key in ('unit',):
            if key in e:
                assert UNIT.match(e[key]), e[key]
        if 'better' in e:
            assert e['better'] in ('lower', 'higher')
        if 'source' in e and group != 'configs':
            assert e['source'] in SOURCES
        for key in ('why', 'layer', 'source'):
            if key in e and isinstance(e[key], str):
                assert 1 <= len(e[key]) <= 200 and '\n' not in e[key] \
                    and '\t' not in e[key]


def test_metric_names_are_unique_across_groups():
    names = [m['name'] for g in ('end_to_end', 'per_layer') for m in SPEC[g]]
    assert len(names) == len(set(names))


def test_end_to_end_metrics_and_bounds():
    e2e = {m['name']: m for m in SPEC['end_to_end']}
    assert 'setup_s' in e2e and e2e['setup_s']['bound'] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    bench = Benchmark(ROOT)
    for w in SPEC['workloads']:
        cell = bench.cell(w['name'])
        names = {m['name'] for m in cell['end_to_end']}
        assert 'setup_s' in names and len(names) >= 2
        assert cell['per_layer']


def test_each_layer_metric_moves_what_its_cells_report():
    bench = Benchmark(ROOT)
    for m in SPEC['per_layer']:
        assert m['workloads']
        for cell in m['workloads']:
            reported = {e['name'] for e in bench.cell(cell)['end_to_end']}
            assert m['moves'] in reported, (m['name'], cell)


def test_cells_configs_and_files():
    cells = SPEC['workloads']
    assert sum(c['chips'] == 4 for c in cells) <= max(1, len(cells) // 4)
    used = {c['config'] for c in cells}
    assert used == {c['name'] for c in SPEC['configs']}
    pairs = [(c['config'], c['traffic']) for c in cells]
    assert len(pairs) == len(set(pairs))
    for c in SPEC['configs']:
        assert c['file'].startswith('benchmark/')
        assert os.path.isfile(os.path.join(ROOT, c['file']))
        assert re.match(r'^https?://', c['source'])
        assert len(c['reduced']) <= 16


def test_every_metric_has_its_reader():
    bench = Benchmark(ROOT)
    for g in ('end_to_end', 'per_layer'):
        for m in SPEC[g]:
            assert callable(bench.reader(m['name']))


def test_a_split_metric_reads_with_its_quantity_reader(tmp_path):
    bench = Benchmark(ROOT)
    assert bench.reader('stream_rtf.bf16').__module__ == \
        bench.reader('stream_rtf').__module__
    (tmp_path / 'benchmark' / 'metrics').mkdir(parents=True)
    (tmp_path / 'benchmark' / 'metrics' / 'a_b.py').write_text(
        'def read(run):\n    return 1.0\n')
    (tmp_path / 'benchmark' / 'metrics' / 'a_b.x.py').write_text(
        'def read(run):\n    return 2.0\n')
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(
        {'workloads': [], 'configs': []}))
    other = Benchmark(str(tmp_path))
    assert other.reader('a_b.x.y')(None) == 2.0
    assert other.reader('a_b.z')(None) == 1.0
    with pytest.raises(FileNotFoundError):
        other.reader('c_d.x')


def foreign_readers(bench):
    """(cell, metric) wherever a cell reports a metric whose reader declares
    the references it counts for, and its configuration's is not one."""
    out = []
    for name in bench.cells:
        cell = bench.cell(name)
        for m in cell['end_to_end'] + cell['per_layer']:
            try:
                bench.reader(m['name'], reference_of(cell['config']))
            except ValueError:
                out.append((name, m['name']))
    return out


def test_each_cell_reads_only_what_counts_its_architecture():
    assert foreign_readers(Benchmark(ROOT)) == []


def test_readers_declare_the_architectures_they_count():
    bench = Benchmark(ROOT)
    for name in ('mfu.stream.bf16', 'sepconv_roofline', 'frontend_roofline'):
        with pytest.raises(ValueError):
            bench.reader(name, 'ast')
        assert callable(bench.reader(name, 'yamnet'))
    for name in ('stream_rtf', 'setup_s', 'device.idle_share.stream',
                 'dispatch.host_ms.stream', 'launch.host_ms.stream',
                 'wire.host_ms.stream', 'h2d.device_ms.stream.bf16'):
        assert callable(bench.reader(name, 'ast'))


def test_a_cell_of_another_architecture_cannot_report_yamnets_work(
        tmp_path):
    spec = json.loads(json.dumps(SPEC))
    cfg = json.load(open(os.path.join(ROOT, spec['configs'][0]['file'])))
    (tmp_path / 'other.json').write_text(json.dumps(
        dict(cfg, reference='ast')))
    spec['configs'][0]['file'] = 'other.json'
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(spec))
    (tmp_path / 'benchmark').symlink_to(os.path.join(ROOT, 'benchmark'))
    cell = spec['workloads'][0]['name']
    assert sorted(m for c, m in foreign_readers(Benchmark(str(tmp_path)))
                  if c == cell) == sorted(
        m['name'] for m in SPEC['per_layer']
        if cell in m['workloads'] and m['name'].split('.')[0] in (
            'mfu', 'sepconv_roofline', 'frontend_roofline'))


def test_layers_are_named_in_perf_md():
    perf = open(os.path.join(ROOT, 'PERF.md')).read()
    for m in SPEC['per_layer']:
        assert f'| {m["layer"]} |' in perf, m['layer']
