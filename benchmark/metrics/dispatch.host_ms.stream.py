"""Host milliseconds a chunk spends in its dispatch (``predict_async``:
padding to whole patches, pinning, the upload and the classify's launches,
and starting its copy back), over the traced run's window: the host's
share of each chunk that a host-bound stream would be held to."""


def read(run):
    chunks = run.outcome['attempted']
    return 1e3 * run.outcome['host_dispatch_s'] / chunks if chunks else None
