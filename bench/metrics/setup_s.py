"""setup_s: seconds from the process's start to the window's start:
imports, weights made on the card, the program's objects, every shape of
the cell run once (and, in a checkout's first run, the kernels built)."""


def read(run):
    return run.setup_s
