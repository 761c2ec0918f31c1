"""What several metric readers share."""


def traced_chunks(run):
    """Chunks dispatched (and finished) inside the traced window, where the
    trace saw the device work at all; else None."""
    if run.trace is None or not run.trace.device:
        return None
    return run.outcome.get('trace_chunks') or None

