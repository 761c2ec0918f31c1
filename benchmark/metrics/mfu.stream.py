"""The whole classify's share of the card's peak: each chunk's work at each
stage's own engine peak (``roofline.classify_s_at_peak``), times the chunks
the traced window ran, over the window."""

from benchmark import roofline
from benchmark.metrics_util import traced_chunks

# the work it counts is YAMNet's
REFERENCES = ('yamnet',)


def read(run):
    chunks = traced_chunks(run)
    if not chunks:
        return None
    per_chunk = roofline.classify_s_at_peak(
        run.outcome['chunk_samples'], run.config['reference_function'],
        roofline.peaks(run.card))
    return 100.0 * chunks * per_chunk / run.trace.window_s
