"""Share of the traced chunk's turn in which the card ran nothing: 100 x
(1 - busy union / the window), the mean over the cards."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.busy_s or tr.window_s <= 0:
        return None
    busy = sum(tr.busy_s.values()) / len(tr.busy_s)
    return 100.0 * (1.0 - busy / tr.window_s)
