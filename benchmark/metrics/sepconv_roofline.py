"""The conv stack's share of its roofline: the least time the card could
take for layers 2-14 and pooling of the chunks the traced window ran
(``roofline.conv_bound_s``), over the device time of the ``sepconv``
library's kernels in it."""

from benchmark import program, roofline
from benchmark.metrics_util import traced_chunks

# the work it counts is YAMNet's
REFERENCES = ('yamnet',)


def read(run):
    chunks = traced_chunks(run)
    if not chunks:
        return None
    busy = run.trace.device_s(program.kernel_matcher('sepconv'))
    if busy <= 0:
        return None
    b = roofline.patches(run.outcome['chunk_samples'])
    bound = roofline.conv_bound_s(b, run.config['reference_function'],
                                  roofline.peaks(run.card))
    return 100.0 * chunks * bound / busy
