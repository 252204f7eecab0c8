"""``cgemm``'s share of its roofline: the least time of the complex
products one iteration needs outside its solve (``work/cgemm.py`` at the
cell's true widths, priced by ``peaks.py``) over the device time of the
``cgemm`` kernels of one iteration in the traced turn, a card's mean.
Nothing is read where no ``cgemm`` kernel ran."""
import peaks
from work import cgemm


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    secs = sum(s for _, name, s in tr.kernels if "cgemm" in name)
    if secs <= 0:
        return None
    w = ctx["widths"]
    work = cgemm.iteration(
        w["chains"], w["n"], w["m"], w["group_times"])
    bound = peaks.bound_seconds(
        products=work["products"], nbytes=work["bytes"])
    per_iter = secs / max(1, len(tr.busy_s)) / ctx["iters_in_turn"]
    return 100.0 * bound / per_iter
