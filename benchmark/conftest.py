"""Pytest settings of the benchmark's own tests (``benchmark/tests``).

``card``: a test that needs a CUDA device; it decides inside the test
(the ``card`` fixture) and skips with a reason where there is none.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line('markers',
                            'card: needs a CUDA device; skips without one')
