"""Device milliseconds of host-to-device copies (the wire upload) per chunk
in the traced window."""

from benchmark.metrics_util import traced_chunks


def read(run):
    chunks = traced_chunks(run)
    if not chunks:
        return None
    busy = run.trace.device_s(lambda name: name.startswith('Memcpy HtoD'))
    return 1e3 * busy / chunks if busy > 0 else None
