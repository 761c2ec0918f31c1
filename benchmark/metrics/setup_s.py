"""Set-up: from the process's start to the first measured moment (imports,
the card's context, the kernel library built or loaded, the bundle loaded,
traffic made, every shape of the cell warmed)."""


def read(run):
    return run.setup_s
