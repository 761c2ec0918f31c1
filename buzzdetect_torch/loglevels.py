"""Log levels, including the custom PROGRESS level (between DEBUG and INFO)
used for per-chunk analysis-rate reports.

Parity: reference `src/pipeline/loglevels.py:3-11`.
"""

import logging

PROGRESS = logging.INFO - 5

loglevels = {
    'NOTSET': logging.NOTSET,
    'DEBUG': logging.DEBUG,
    'PROGRESS': PROGRESS,
    'INFO': logging.INFO,
    'WARNING': logging.WARNING,
    'ERROR': logging.ERROR,
    'CRITICAL': logging.CRITICAL,
}
