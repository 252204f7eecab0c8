"""Seconds the timed call(s) spent building every row's operators on the
host and moving them to the cards: the runner's ``timings["scatter"]``."""


def read(ctx):
    return sum(c["timings"]["scatter"] for c in ctx["calls"])
