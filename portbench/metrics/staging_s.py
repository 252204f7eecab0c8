"""Seconds the timed call(s) spent copying the samples from the pinned
staging buffers into the host's arrays: the runner's
``timings["staging"]`` (absent on a path that fetches synchronously)."""


def read(ctx):
    vals = [c["timings"].get("staging") for c in ctx["calls"]]
    return None if None in vals else sum(vals)
