"""setup_s: from the process's start to the window's: imports, the
kernels' build (a checkout's first run), the weights drawn on the card,
the engine, and the warm-up on the cell's own traffic."""


def read(run):
    return run.setup_s
