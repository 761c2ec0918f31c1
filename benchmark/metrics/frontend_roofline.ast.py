"""The Kaldi fbank's share of its roofline: the least time the card could
take for the fbank of the traced window's chunks (``roofline_ast.
fbank_bound_s``), over the device time launched inside their
``buzzdetect.frontend`` spans."""

from benchmark import roofline, roofline_ast, spans

# the work it counts is AST's
REFERENCES = ('ast',)


def read(run):
    s = spans.of(run)
    if s is None or not s.chunks:
        return None
    busy = s.device_s('buzzdetect.frontend')
    if busy <= 0:
        return None
    bound = roofline_ast.fbank_bound_s(run.outcome['chunk_samples'],
                                       run.config,
                                       roofline.peaks(run.card))
    return 100.0 * s.chunks * bound / busy
