"""Host milliseconds a chunk spends staging its wire buffer: inside the
program's ``buzzdetect.wire`` (``to_wire`` and padding) and
``buzzdetect.upload`` (pinning and the non-blocking copy's enqueue) spans,
over the traced window's chunks."""

from benchmark import spans


def read(run):
    return spans.per_chunk_ms(run, ('buzzdetect.wire', 'buzzdetect.upload'))
