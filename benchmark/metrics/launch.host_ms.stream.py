"""Host milliseconds a chunk spends inside the program's
``buzzdetect.classify`` span: every launch of the classify (frontend,
embed, head), on the dispatch thread, over the traced window's chunks."""

from benchmark import spans


def read(run):
    return spans.per_chunk_ms(run, ('buzzdetect.classify',))
