"""Posterior samples per second: rows x iterations completed over the
harness's wall clock around the whole timed call(s). One sample is one
iteration of one chain of one baseline."""


def read(ctx):
    calls = ctx["calls"]
    return (ctx["rows"] * sum(c["niter"] for c in calls)
            / sum(c["wall"] for c in calls))
