"""BEATs' attention's share of its roofline: the least time the card could
take for the attention of the traced window's chunks (``roofline_beats.
attention_bound_s``: every block's QK^T, PV and gate at the bf16 peak, or
q, k, v, o and the bias rows at the memory's), over the device time
launched inside their ``buzzdetect.attention`` spans (``benchmark/spans.py``:
by each launch's runtime call, never by a kernel's name)."""

from benchmark import roofline, roofline_ast, roofline_beats, spans

# the work it counts is BEATs'
REFERENCES = ('beats',)


def read(run):
    s = spans.of(run)
    if s is None or not s.chunks:
        return None
    busy = s.device_s('buzzdetect.attention')
    if busy <= 0:
        return None
    sizes = run.config['sizes']
    w = roofline_ast.windows(run.outcome['chunk_samples'], sizes,
                             run.config['framehop_prop'])
    bound = roofline_beats.attention_bound_s(w, sizes,
                                             roofline.peaks(run.card))
    return 100.0 * s.chunks * bound / busy
