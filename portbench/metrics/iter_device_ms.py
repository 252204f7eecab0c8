"""Device milliseconds of one iteration: the union of the card's kernel,
copy and set records in the traced chunk's turn over the chunk's
iterations, the mean over the cards."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.busy_s:
        return None
    busy = sum(tr.busy_s.values()) / len(tr.busy_s)
    return 1e3 * busy / ctx["iters_in_turn"]
