"""Seconds from the process's start to the first timed call: imports, the
kernels' build (first run in a checkout only) and load, the data, and
the warm call."""


def read(ctx):
    return ctx["setup_s"]
