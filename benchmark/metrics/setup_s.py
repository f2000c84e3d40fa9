"""Seconds from the process's start to the first timed call: imports, the
kernels' build on a checkout's first run, inputs and weights from the seed,
the program's objects and the warm-up calls."""


def read(run):
    return run["setup_s"]
