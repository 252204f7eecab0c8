"""The comparison that decides ``correct``: a sample, drawn from the seed,
of the (chain, iteration) samples the timed call produced, each held
against the plain reference (``reference/sampler.py``) run from the state
that iteration started from: the program's own bandpowers of the
iteration before, or for iteration 0 the chain's initial state, which the
reference works out itself. The program carries more than the bandpowers
from one iteration to the next (a warm-started system inverse); the
reference solves each iteration exactly, so that carried state is judged
by the samples it yields.

Four numbers are compared, each the widest gap over the sample:
``ps_gap``, the relative gap of a bandpower of a free bin; ``prior_gap``,
the gap of a bounded bin's draw in the conditional's own probability,
``|Q(alpha + 1, beta / x_program) - Q(alpha + 1, beta / x_reference)|``
with the reference's ``beta`` (where the prior's bounds lie far in the
conditional's tail both draws sit by the bound, and a float32 table of
``Q`` rounds their places apart in x by percents and in probability by
less than its own rounding); ``chisq_gap``, the relative gap of the
iteration's chi^2; ``lnpost_gap``, of its log posterior against the
reference's at the program's own bandpowers (the draw is judged by the
two gaps before). A sample that is not finite reads an infinite gap.
"""
import numpy as np
from scipy.special import gammaincc

from reference import sampler

N_RANDOM, N_STARTS, N_ENDS, N_CHUNK_STARTS = 192, 8, 8, 8
NUMBERS = ("ps_gap", "prior_gap", "chisq_gap", "lnpost_gap")


def pick(seed: int, rows: int, niter: int, write_niter: int):
    """``(row, iteration)`` pairs: random ones over every row and
    iteration, some first and last iterations, some first iterations of a
    chunk (where the program rebuilds its carried inverse)."""
    rng = np.random.default_rng([seed % 2 ** 32, seed // 2 ** 32, 0xC4EC])
    r = lambda k: rng.integers(0, rows, k)
    its = np.concatenate([
        rng.integers(0, niter, N_RANDOM), np.zeros(N_STARTS, int),
        np.full(N_ENDS, niter - 1),
        write_niter * rng.integers(0, max(1, niter // write_niter),
                                   N_CHUNK_STARTS)])
    rws = np.concatenate([r(N_RANDOM), r(N_STARTS), r(N_ENDS),
                          r(N_CHUNK_STARTS)])
    return sorted(set(zip(rws.tolist(), its.tolist())))


def gaps(got: dict, want: dict, bounded, alpha: int) -> dict:
    rel = lambda a, b: float(np.max(np.abs(np.asarray(a, float) - b)
                                    / np.abs(b), initial=0.0))
    free = np.ones(len(want["ps"]), bool)
    free[bounded] = False
    ps = np.asarray(got["ps"], float)
    cdf = lambda x: gammaincc(alpha + 1.0, want["beta"][bounded] / x)
    out = {"ps_gap": rel(ps[free], want["ps"][free]),
           "prior_gap": float(np.max(np.abs(cdf(ps[bounded])
                                            - cdf(want["ps"][bounded])),
                                     initial=0.0)),
           "chisq_gap": rel(got["chisq"], want["chisq"]),
           "lnpost_gap": rel(got["ln_post"], sampler.ln_post(
               want["noise"], want["bmask"], ps))}
    return {k: (v if np.isfinite(v) else float("inf"))
            for k, v in out.items()}


def verdict(worst: dict, limits: dict, failed: int = 0):
    """``(correct, compared)``: each number beside its limit, and whether
    every one lies within it with no sample lost."""
    compared = {k: {"value": worst[k], "limit": limits[k]} for k in NUMBERS}
    return (failed == 0 and all(v["value"] <= v["limit"]
                                for v in compared.values()), compared)


def run(samples, baselines, sids, seed, prior, ps0, precision="fp64"):
    """Widest gaps over ``samples``: ``{(row, it): {"prev": ps or None,
    "ps", "chisq", "ln_post"}}`` of the program, ``baselines`` the
    :class:`sampler.Baseline` of each row, ``sids`` each row's stream
    id."""
    bounded = sampler.bounded_bins(prior)[0]
    ntimes = baselines[0].vis.shape[0]
    table = sampler.invgamma_table(float(ntimes))
    worst = dict.fromkeys(NUMBERS, 0.0)
    for (row, it), got in samples.items():
        bl = baselines[row]
        prev = ps0 if got["prev"] is None else got["prev"]
        rnd = sampler.randomness(bl, seed, sids[row], it, len(bounded))
        want = sampler.step(bl, prev, rnd, prior, table, precision)
        for k, v in gaps(got, want, bounded, ntimes - 1).items():
            worst[k] = max(worst[k], v)
    return worst
