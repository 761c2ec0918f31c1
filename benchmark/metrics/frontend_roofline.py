"""The frontend's share of its roofline: the least time the card could take
for the log-mel of the traced window's chunks, over the device time
launched inside their ``buzzdetect.frontend`` spans (``benchmark/spans.py``:
by each launch's runtime call, never by a kernel's name).

The bound of a chunk is the larger of its frontend work
(``roofline.frontend_flops``) at the f32 peak, which the frontend runs at
under every configuration, and its bytes at the memory's peak: the wire
read once and the f32 patches written once."""

import numpy as np

from benchmark import roofline, spans

# the work it counts is YAMNet's
REFERENCES = ('yamnet',)


def bound_s(n_samples: int, wire_dtype: str, peak: dict) -> float:
    """The least time of one chunk's frontend on the card of ``peak``."""
    nbytes = (n_samples * np.dtype(wire_dtype).itemsize
              + roofline.patches(n_samples) * roofline.PATCH[0]
              * roofline.PATCH[1] * 4)
    return max(roofline.frontend_flops(n_samples) / peak['f32'],
               nbytes / peak['bytes'])


def read(run):
    s = spans.of(run)
    if s is None or not s.chunks:
        return None
    busy = s.device_s('buzzdetect.frontend')
    if busy <= 0:
        return None
    bound = bound_s(run.outcome['chunk_samples'],
                    run.config['transfer_dtype'], roofline.peaks(run.card))
    return 100.0 * s.chunks * bound / busy
