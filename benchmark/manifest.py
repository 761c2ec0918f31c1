"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Everything that belongs to one of them, or to one metric, is a file of its
own under ``benchmark/``:

* ``configs/<config>.json``: the configuration as it is run. It names its
  plain reference (``reference``: ``reference/<name>.py``, YAMNet's where
  it names none), and may hold a ``rehearsal`` of keys merged over it in a
  CPU rehearsal alone (a tiny bundle of the same architecture, say);
* ``reference/<name>.py``: a plain reference, with ``scores(config,
  inputs, device, precision)`` that finds its own weights;
* ``traffic/<traffic>.json``: the mix's generator (``traffic/<generator>.py``),
  the entry that drives the program (``entries/<entry>.py``) and their
  parameters;
* ``workloads/<cell>.json``: the cell's configuration and traffic (as
  ``BENCHMARK.json`` has them) and the limits of its correctness checks;
* ``metrics/<metric>.py``: a reader with ``read(run)`` that returns the
  metric's value, or None where it finds nothing to read. A metric split
  by cells, ``<metric>.<part>`` (one quantity under a bound or a ``moves``
  of its own in some cells), reads with ``<metric>``'s reader unless it
  has a file of its own. A reader that counts one architecture's work
  declares the references it counts for (``REFERENCES``), and reads for
  no cell whose configuration names another.

So a later change adds a configuration, a mix, a cell or a metric as new
files (and entries in ``BENCHMARK.json``) and edits none.
"""

import importlib.util
import json
import os
import re

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
SOURCES = ('device_trace', 'program_span', 'program_counter', 'host_clock')
DEFAULT_REFERENCE = 'yamnet'


def check_name(name: str, what: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f'{what} {name!r}: a name is 1-64 letters, digits, '
                         f'_ . -, starting with a letter, digit or _')
    return name


def reference_of(config: dict) -> str:
    """The plain reference a configuration names: the module
    ``reference/<name>.py``."""
    return check_name(config.get('reference', DEFAULT_REFERENCE),
                      'reference')


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import the Python file at ``path`` under the module name ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Benchmark:
    """``BENCHMARK.json`` at ``root``, with the files under ``root/benchmark``
    that its names point to."""

    def __init__(self, root: str):
        self.root = root
        self.dir = os.path.join(root, 'benchmark')
        self.spec = _json(os.path.join(root, 'BENCHMARK.json'))
        self.cells = {w['name']: w for w in self.spec['workloads']}
        self.configs = {c['name']: c for c in self.spec['configs']}

    def path(self, *parts) -> str:
        return os.path.join(self.dir, *parts)

    def cell(self, name: str, rehearse: bool = False) -> dict:
        """The cell ``name`` resolved: its entry, configuration, traffic,
        limits and metrics. ``rehearse``: with the configuration's and the
        traffic's ``rehearsal`` merged over them."""
        if name not in self.cells:
            raise KeyError(f'no workload {name!r} in BENCHMARK.json (known: '
                           f'{", ".join(self.cells)})')
        w = self.cells[name]
        cfg_entry = self.configs[w['config']]
        config = _json(os.path.join(self.root, cfg_entry['file']))
        traffic = _json(self.path('traffic',
                                  check_name(w['traffic'], 'traffic')
                                  + '.json'))
        own = _json(self.path('workloads', check_name(name, 'workload')
                              + '.json'))
        for key in ('config', 'traffic'):
            if own.get(key) != w[key]:
                raise ValueError(f'workloads/{name}.json names {key} '
                                 f'{own.get(key)!r}, BENCHMARK.json '
                                 f'{w[key]!r}')
        if rehearse:
            config = {**config, **config.get('rehearsal', {})}
            traffic = dict(traffic, params={**traffic['params'],
                                            **traffic.get('rehearsal', {})})
        return dict(name=name, chips=w['chips'], config_name=w['config'],
                    config=config, traffic_name=w['traffic'],
                    traffic=traffic, limits=own['limits'],
                    end_to_end=self.metrics('end_to_end', name),
                    per_layer=self.metrics('per_layer', name))

    def metrics(self, group: str, cell: str):
        """The metrics of ``group`` that ``cell`` reports: those that list
        it under ``workloads``, and those without a list, which every cell
        reports (a per-layer metric without a list: every cell that reports
        the end-to-end metric it moves)."""
        out = []
        e2e = {m['name'] for m in self.metrics('end_to_end', cell)} \
            if group == 'per_layer' else None
        for m in self.spec[group]:
            if 'workloads' in m:
                if cell in m['workloads']:
                    out.append(m)
            elif group == 'end_to_end' or m['moves'] in e2e:
                out.append(m)
        return out

    def reader(self, metric: str, reference: str = None):
        """``metrics/<metric>.py``'s ``read``; for ``<metric>.<part>``
        without a file of its own, ``<metric>``'s. With ``reference`` (a
        cell's), a ValueError where the reader declares the references it
        counts for and that is not one of them."""
        name = check_name(metric, 'metric')
        while not os.path.isfile(self.path('metrics', name + '.py')) \
                and '.' in name:
            name = name.rsplit('.', 1)[0]
        module = load_module(self.path('metrics', name + '.py'),
                             'benchmark_metric_' + re.sub(r'\W', '_', name))
        counts = getattr(module, 'REFERENCES', None)
        if reference is not None and counts is not None \
                and reference not in counts:
            raise ValueError(f'{metric}: metrics/{name}.py counts the work of '
                             f'{", ".join(counts)}, not of {reference}')
        return module.read

    def module(self, folder: str, name: str):
        """``<folder>/<name>.py`` (a traffic generator or an entry)."""
        return load_module(self.path(folder, check_name(name, folder)
                                     + '.py'),
                           f'benchmark_{folder}_{name}')
