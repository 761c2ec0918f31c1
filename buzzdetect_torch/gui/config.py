"""GUI theme and behavior constants (parity: reference `src/gui/config.py:1-24`).

Copy of ``buzzdetect_tpu/gui/config.py``, import prefix changed; no other edit.
"""

FONT_FAMILY = 'TkDefaultFont'
FONT_SIZE = 12
FONT_SIZE_TITLE = 18

# per-log-level text colors in the analysis window
LEVEL_COLORS = {
    'DEBUG': '#888888',
    'PROGRESS': '#4a9eda',
    'INFO': '#dddddd',
    'WARNING': '#e0a030',
    'ERROR': '#e05050',
    'CRITICAL': '#ff2020',
}

# how often the analysis window drains the GUI log queue (ms)
POLL_INTERVAL_MS = 100

# settings cache file, stored next to the working directory
FNAME_GUISETTINGS = 'guisettings.json'
