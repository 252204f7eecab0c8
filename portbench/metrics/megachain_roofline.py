"""The whole iteration's share of its roofline: the least time one
iteration of a card's chains needs (``work/megachain.py`` at the cell's
true widths, priced by ``peaks.py``) over the card's device time of one
iteration (``iter_device_ms``'s reading)."""
import peaks
from work import megachain


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.busy_s:
        return None
    w = ctx["widths"]
    work = megachain.iteration(
        w["chains"], w["baselines"], w["n"], w["m"], w["group_times"],
        w["alpha"])
    bound = peaks.bound_seconds(
        work["products"], work["other"], work["bytes"])
    busy = sum(tr.busy_s.values()) / len(tr.busy_s)
    return 100.0 * bound / (busy / ctx["iters_in_turn"])
