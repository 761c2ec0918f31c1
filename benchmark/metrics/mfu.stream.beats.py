"""The BEATs classify's share of the card's peak: each chunk's work at each
engine's peak (``roofline_beats.chunk_s_at_peak``: the products at bf16, the
fbank at f32), times the chunks the traced window ran, over the window."""

from benchmark import roofline, roofline_beats
from benchmark.metrics_util import traced_chunks

# the work it counts is BEATs'
REFERENCES = ('beats',)


def read(run):
    chunks = traced_chunks(run)
    if not chunks:
        return None
    per_chunk = roofline_beats.chunk_s_at_peak(
        run.outcome['chunk_samples'], run.config, roofline.peaks(run.card))
    return 100.0 * chunks * per_chunk / run.trace.window_s
