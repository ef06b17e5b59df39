"""setup_s: seconds from the process's start to the window's: imports, the
kernels' build (first run in a checkout), weights, warm-up."""


def read(run):
    return run.setup_s
