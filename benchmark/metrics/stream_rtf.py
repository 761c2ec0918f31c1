"""Audio seconds of the chunks whose scores reached host memory inside the
window, over the window."""


def read(run):
    return run.outcome['audio_s'] / run.outcome['window_s']
