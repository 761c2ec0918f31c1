"""The comparisons that decide ``correct``.

Each number compared has its limit in ``workloads/<cell>.json``; a run is
correct when every number is at or under its limit. The numbers:

* ``score_gap``: the widest gap, over every answer the window produced,
  between a score the program served and the plain reference's score for
  the same samples (``reference/<name>.py``, the one the configuration
  names, in the configuration's function);
* ``csv_excess``: the same for the CSVs the pipeline wrote, beyond the half
  unit of their last digit that rounding allows;
* counts that must be 0: answers that never came (``missing``), answers
  of the wrong shape (``bad_shape``), CSV rows that belong to no chunk or
  chunks with rows missing (``bad_rows``), a window that wrote no row
  (``no_rows``).
"""

import os
import re

import numpy as np

from benchmark.manifest import load_module, reference_of

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Check:
    def __init__(self, name, value, limit):
        self.name, self.value, self.limit = name, float(value), float(limit)

    @property
    def ok(self) -> bool:
        return self.value <= self.limit

    def line(self) -> str:
        return (f'check {self.name} {self.value!r} limit {self.limit!r} '
                f'{"ok" if self.ok else "FAILED"}')


def reference_scores(config: dict, inputs: dict, device,
                     precision: str = None, root: str = ROOT) -> dict:
    """{key: reference scores} for {key: int16 samples}: the ``scores`` of
    the plain reference the configuration names
    (``benchmark/reference/<name>.py`` under ``root``), in ``precision``
    (the configuration's function by default), on ``device``."""
    name = reference_of(config)
    module = load_module(os.path.join(root, 'benchmark', 'reference',
                                      name + '.py'),
                         'benchmark_reference_' + re.sub(r'\W', '_', name))
    return module.scores(config, inputs, device,
                         precision or config['reference_function'])


def answer_checks(outputs, refs: dict, limits: dict, attempted: int):
    """Checks of served answers: ``outputs`` is [(key, scores), ...]."""
    gap, bad = 0.0, 0
    for key, out in outputs:
        ref = refs[key]
        if out.shape != ref.shape:
            bad += 1
            continue
        gap = max(gap, float(np.abs(out - ref).max()))
    return [Check('score_gap', gap, limits['score_gap']),
            Check('missing', attempted - len(outputs), 0),
            Check('bad_shape', bad, 0)]
