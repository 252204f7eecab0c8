"""The whole iteration's share of the card's product peak: the complex
products one iteration of a card's chains needs (``work/megachain.py`` at
the cell's true widths) at the FP32-grade product rate (``peaks.py``),
over the card's device time of one iteration (``iter_device_ms``'s
reading). It counts products alone, so it never exceeds
``megachain_roofline``, which also weighs the draws and the bytes."""
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
    least = peaks.bound_seconds(products=work["products"])
    busy = sum(tr.busy_s.values()) / len(tr.busy_s)
    return 100.0 * least / (busy / ctx["iters_in_turn"])
