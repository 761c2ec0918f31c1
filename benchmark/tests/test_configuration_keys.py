"""What a configuration file decides beside its sizes: the ``rehearsal``
merged over it in a CPU rehearsal alone, and the loader arguments it
states."""

import json
import os

import pytest

from benchmark import control, program, run
from benchmark.manifest import Benchmark

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SPEC = json.load(open(os.path.join(ROOT, 'BENCHMARK.json')))
CELLS = [w['name'] for w in SPEC['workloads']]


def _with_rehearsal(tmp_path):
    """A checkout whose first cell's configuration holds a ``rehearsal``."""
    spec = json.loads(json.dumps(SPEC))
    cell = spec['workloads'][0]
    entry = [c for c in spec['configs'] if c['name'] == cell['config']][0]
    cfg = json.load(open(os.path.join(ROOT, entry['file'])))
    cfg['rehearsal'] = {'model': 'tiny_bundle', 'host_threads': 3}
    (tmp_path / 'c.json').write_text(json.dumps(cfg))
    entry['file'] = 'c.json'
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(spec))
    (tmp_path / 'benchmark').symlink_to(os.path.join(ROOT, 'benchmark'))
    return Benchmark(str(tmp_path)), cell['name'], cfg


def test_the_rehearsal_is_merged_under_rehearse_alone(tmp_path):
    bench, name, cfg = _with_rehearsal(tmp_path)
    chip = bench.cell(name)
    assert chip['config'] == cfg
    cpu = bench.cell(name, rehearse=True)
    assert cpu['config'] == dict(cfg, model='tiny_bundle', host_threads=3)
    traffic = json.load(open(bench.path('traffic', chip['traffic_name']
                                        + '.json')))
    assert chip['traffic']['params'] == traffic['params']
    assert cpu['traffic']['params'] == {**traffic['params'],
                                        **traffic['rehearsal']}


@pytest.mark.parametrize('workload', CELLS)
def test_a_configuration_without_a_rehearsal_rehearses_as_it_is(workload):
    bench = Benchmark(ROOT)
    assert bench.cell(workload, rehearse=True)['config'] == \
        bench.cell(workload)['config']


@pytest.mark.parametrize('main', [run.main, control.main])
@pytest.mark.parametrize('rehearse', [False, True])
def test_run_and_control_ask_for_the_rehearsal_on_rehearse_alone(
        monkeypatch, main, rehearse):
    asked = []

    class Stop(Exception):
        pass

    def cell(self, name, rehearse=False):
        asked.append(rehearse)
        raise Stop
    monkeypatch.setattr(Benchmark, 'cell', cell)
    argv = ['--workload', CELLS[0], '--seed', '1', '--seconds', '1'] \
        if main is run.main else ['--workload', CELLS[0], '--seeds', '1']
    with pytest.raises(Stop):
        main(argv + (['--rehearse'] if rehearse else []))
    assert asked == [rehearse]


class _Loaded:
    def initialize(self):
        self.initialized = True


@pytest.fixture
def loader(monkeypatch):
    """The program's loader replaced by one that records its arguments."""
    from buzzdetect_torch.models import registry
    calls = []

    def load(name, **kwargs):
        calls.append((name, kwargs))
        return _Loaded()
    monkeypatch.setattr(registry, 'load_model', load)
    return calls


@pytest.mark.parametrize('config', [c['file'] for c in SPEC['configs']])
def test_the_configurations_load_as_they_state(loader, config):
    cfg = json.load(open(os.path.join(ROOT, config)))
    assert program.load_model(cfg, 'cpu').initialized
    assert loader == [(cfg['model'], dict(
        device='cpu', compute_dtype=cfg['compute_dtype'],
        transfer_dtype=cfg['transfer_dtype'], frontend=cfg['frontend'],
        conv=cfg['conv'], conv_precision=cfg['conv_precision'],
        framehop_prop=cfg['framehop_prop']))]


def test_a_configuration_passes_only_the_arguments_it_states(loader):
    cfg = json.load(open(os.path.join(ROOT, SPEC['configs'][0]['file'])))
    for key in program.STATED:
        del cfg[key]
    cfg['conv'] = 'xla'
    program.load_model(cfg, 'cpu')
    assert loader == [(cfg['model'], dict(
        device='cpu', compute_dtype=cfg['compute_dtype'],
        transfer_dtype=cfg['transfer_dtype'], conv='xla',
        framehop_prop=cfg['framehop_prop']))]
