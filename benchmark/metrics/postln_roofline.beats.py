"""BEATs' deep-norm post-LN's share of its roofline: the least time the
card could take for the post-LNs of the traced window's chunks
(``roofline_beats.postln_bound_s``: 14 bytes a value at the memory's peak,
two a block), over the device time launched inside their
``buzzdetect.post_ln`` spans. A program without the span reads nothing."""

from benchmark import roofline, roofline_ast, roofline_beats, spans

# the work it counts is BEATs'
REFERENCES = ('beats',)


def read(run):
    s = spans.of(run)
    if s is None or not s.chunks:
        return None
    busy = s.device_s('buzzdetect.post_ln')
    if busy <= 0:
        return None
    sizes = run.config['sizes']
    w = roofline_ast.windows(run.outcome['chunk_samples'], sizes,
                             run.config['framehop_prop'])
    bound = roofline_beats.postln_bound_s(w, sizes, roofline.peaks(run.card))
    return 100.0 * s.chunks * bound / busy
