"""The long-run posterior oracle of the synthetic problem, on the CPU.

    python -m hydra_pspec_torch.validation.oracle [--niter 25000]
        [--nburn 2500] [--nchains 4] [--workers 8]

Runs the reference-semantics NumPy Gibbs sampler (this module's copy of
``scripts/make_oracle_posterior.py``'s ``oracle_step``,
``run_oracle_chain`` and ``posterior_stats`` and of the three
``tests/reference_impl.py`` functions they call) for long chains on the
synthetic problem of ``validation/synth.py``, unflagged and with the flag
pattern ``synth.FLAG_CHANNELS``, and writes per-delay-bin posterior
statistics with Monte-Carlo error estimates to
``validation/oracle_posterior_synth.json``, in the schema of
``tests/oracle_posterior.json``:

    mean/sd/ESS of log(bandpower)  -> the z-comparison's denominator
    q5/q50/q95 of bandpower        -> the CI-overlap check
    split-Rhat                     -> the convergence gate on the oracle

``validation/validate.py`` holds the port's engines against it. Unlike
``scripts/make_oracle_posterior.py`` this writes no thinned draws sidecar
(``.draws.npz``): the acceptance reads the statistics only.

Two exact algebraic shortcuts are used for speed (module docstring of
``scripts/make_oracle_posterior.py``): sqrtm(S) = F^H diag(sqrt(ps) /
n^1.5) F, and the iteration-constant diagonal Ni = w Ninv w.
Each worker runs one chain single-threaded (one BLAS thread each); both
cases' chains run in one pool.
"""
import argparse
import json
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

for _v in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_v, "1")

import numpy as np
from scipy.stats import invgamma

from ..utils.mcstats import ess_geyer
from . import synth

OUT = Path(__file__).resolve().parent / "oracle_posterior_synth.json"
ORACLE_SEED = 20261017
NITER, NBURN, NCHAINS = 25000, 2500, 4
CASES = (("unflagged", None), ("flagged", synth.FLAG_CHANNELS))


# --- copies of tests/reference_impl.py ----------------------------------------

def fourier_operator(n):
    i = (np.arange(n) - n // 2).reshape(1, -1)
    k = (np.arange(n) - n // 2).reshape(-1, 1)
    return np.exp(-2j * np.pi * (i * k) / n)


def delay_transform(s):
    """Centred FFT over the last axis (reference pspec.py:91-95)."""
    return np.fft.fftshift(
        np.fft.fft(np.fft.ifftshift(s, axes=-1), axis=-1), axes=-1
    )


def sample_S_beta_alpha(signal_cr):
    sk = delay_transform(signal_cr)
    beta = np.sum(np.abs(sk) ** 2, axis=0)
    alpha = signal_cr.shape[0] - 1.0
    return beta, alpha


def truncated_invgamma_oracle(u, alpha, beta, lo, hi, ngrid=1000):
    """Reference inversion sampler (pspec.py:11-64) with injectable u."""
    x = np.logspace(np.log10(lo), np.log10(hi), ngrid)
    cdf = invgamma.cdf(x, a=alpha, loc=0, scale=beta)
    cdf = cdf - cdf.min()
    cdf = cdf / cdf.max()
    cdf_u, idx = np.unique(cdf, return_index=True)
    return float(np.interp(u, cdf_u, x[idx]))


# --- copies of scripts/make_oracle_posterior.py -------------------------------

def oracle_step(d_w, ni_diag, fgmodes, F, Fh, ps, oa, ob):
    """One reference-semantics GCR draw for all times (pspec.py:219-228
    math with the two exact shortcuts of the module docstring). Returns
    (signal_cr, fg_amps)."""
    n = d_w.shape[1]
    m = fgmodes.shape[1]
    fgH = fgmodes.conj().T
    S = Fh @ (ps[:, None] / n**2 * F)
    Sh = Fh @ (np.sqrt(ps)[:, None] / n**1.5 * F)
    SNi = S * ni_diag[None, :]          # S @ diag(ni)
    SNih = S * np.sqrt(ni_diag)[None, :]
    # block A exactly as reference pspec.py:365-369
    A = np.zeros((n + m, n + m), dtype=complex)
    A[:n, :n] = np.eye(n) + SNi
    A[:n, n:] = SNi @ fgmodes
    A[n:, :n] = fgH * ni_diag[None, :]
    A[n:, n:] = (fgH * ni_diag[None, :]) @ fgmodes
    # GCR right-hand sides for all times at once (pspec.py:219-222)
    top = d_w @ SNi.T + oa @ Sh.T + ob @ SNih.T
    bot = (d_w * ni_diag[None, :] + ob * np.sqrt(ni_diag)[None, :]) @ fgmodes.conj()
    X = np.linalg.solve(A, np.concatenate([top, bot], axis=1).T)
    return X[:n].T, X[n:].T


def run_oracle_chain(seed, niter, d, w, ninv, fgmodes, eor_cov, prior):
    """One Gibbs chain with reference semantics; returns (ps, chisq_masked)
    where ps is (niter, nfreqs) bandpower samples and chisq_masked the
    per-iteration mean chi^2 over unflagged channels."""
    nt, n = d.shape
    rng = np.random.default_rng(seed)
    F = fourier_operator(n)
    Fh = F.conj().T
    d_w = d * w
    unflagged = w.astype(bool)
    ni_diag = ninv * w * w
    prior_on = (prior[0] > 0) | (prior[1] > 0)

    # initial S from the supplied covariance, like the reference driver
    ps = np.clip(np.diagonal(F @ eor_cov @ Fh).real, 1e-20, None)

    ps_out = np.empty((niter, n))
    chi_out = np.empty(niter)
    for it in range(niter):
        oa = (rng.standard_normal((nt, n)) + 1j * rng.standard_normal((nt, n))) / np.sqrt(2)
        ob = (rng.standard_normal((nt, n)) + 1j * rng.standard_normal((nt, n))) / np.sqrt(2)
        signal_cr, fg_amps = oracle_step(d_w, ni_diag, fgmodes, F, Fh, ps, oa, ob)
        # bandpower draw (pspec.py:67-127)
        beta, alpha = sample_S_beta_alpha(signal_cr)
        new_ps = np.empty(n)
        for k in range(n):
            if prior_on[k]:
                new_ps[k] = truncated_invgamma_oracle(
                    rng.uniform(), alpha + 1, beta[k], prior[1, k], prior[0, k])
            else:
                # invgamma(alpha, scale=beta) == beta / Gamma(alpha)
                new_ps[k] = beta[k] / rng.gamma(alpha)
        ps = new_ps
        ps_out[it] = ps
        model = signal_cr + fg_amps @ fgmodes.T
        chi = np.abs(d_w - model) ** 2 * ninv[None, :]
        chi_out[it] = chi[:, unflagged].mean()
    return ps_out, chi_out


def _worker(args):
    return run_oracle_chain(*args)


def gelman_rubin(ps_chains):
    """Split-R-hat over chains: (Nchains, Niter, Nfreqs) -> (Nfreqs,)
    (a copy of ``runner.gelman_rubin``, which imports torch)."""
    c, n, k = ps_chains.shape
    half = n // 2
    x = np.concatenate((ps_chains[:, :half], ps_chains[:, half: 2 * half]),
                       axis=0)
    nn = x.shape[1]
    B = nn * x.mean(axis=1).var(axis=0, ddof=1)
    W = x.var(axis=1, ddof=1).mean(axis=0)
    var_hat = (nn - 1) / nn * W + B / nn
    return np.sqrt(var_hat / np.maximum(W, 1e-300))


def posterior_stats(ps_chains, nburn):
    """ps_chains: (nchains, niter, nfreqs). Returns the per-bin statistics
    dict used by the acceptance comparison."""
    post = ps_chains[:, nburn:, :]                      # (m, nd, n)
    logp = np.log(post)
    mean_log = logp.mean(axis=(0, 1))
    sd_log = logp.reshape(-1, post.shape[2]).std(axis=0, ddof=1)
    ess = np.array([ess_geyer(logp[:, :, k]) for k in range(post.shape[2])])
    q5, q50, q95 = np.percentile(post.reshape(-1, post.shape[2]),
                                 [5, 50, 95], axis=0)
    rhat = gelman_rubin(post)
    return {
        "mean_log_ps": mean_log.round(6).tolist(),
        "sd_log_ps": sd_log.round(6).tolist(),
        "ess_log_ps": ess.round(1).tolist(),
        "q5_ps": [float(f"{v:.6g}") for v in q5],
        "q50_ps": [float(f"{v:.6g}") for v in q50],
        "q95_ps": [float(f"{v:.6g}") for v in q95],
        "split_rhat_max": round(float(np.nanmax(rhat)), 4),
        "split_rhat_median": round(float(np.nanmedian(rhat)), 4),
    }


def edge_bins(nf):
    """The EoR-dominated outer delay bins of the truth ratio (0:40 and
    80:120 at 120 channels, scripts/validate_posterior.py:186)."""
    return np.r_[0:nf // 3, nf - nf // 3:nf]


def case_stats(ps_chains, chi, nburn, dps_true, flag_channels):
    """posterior_stats plus the chi^2 and truth-ratio entries of one case
    (scripts/make_oracle_posterior.py:236-273)."""
    stats = posterior_stats(ps_chains, nburn)
    stats["chisq_postburn_mean"] = round(float(chi[:, nburn:].mean()), 5)
    if flag_channels:
        stats["flag_channels"] = flag_channels
    post = ps_chains[:, nburn:, :]
    edge = edge_bins(post.shape[2])
    ratio = post.mean(axis=(0, 1))[edge] / dps_true[edge]
    stats["edge_ratio_median"] = round(float(np.median(ratio)), 4)
    stats["edge_ratio_p5"] = round(float(np.percentile(ratio, 5)), 4)
    stats["edge_ratio_p95"] = round(float(np.percentile(ratio, 95)), 4)
    # the spread of the median edge ratio of 170-draw windows
    wlen = 170
    nwin = post.shape[1] // wlen
    wr = [float(np.median(post[c, i * wlen:(i + 1) * wlen].mean(axis=0)[edge]
                          / dps_true[edge]))
          for c in range(post.shape[0]) for i in range(nwin)]
    if wr:
        stats["e2e_window_ratio_median"] = {
            "window_len": wlen, "n_windows": len(wr),
            "min": round(min(wr), 4), "max": round(max(wr), 4),
            "p1": round(float(np.percentile(wr, 1)), 4),
            "p99": round(float(np.percentile(wr, 99)), 4),
        }
    return stats


def chain_seed(seed, chain, flagged):
    """The chain's numpy seed (scripts/make_oracle_posterior.py:233)."""
    return seed + 1000 * chain + (7 if flagged else 0)


def build(niter=NITER, nburn=NBURN, nchains=NCHAINS, seed=ORACLE_SEED,
          synth_seed=synth.SEED, workers=8, cases=CASES):
    """The oracle artifact as a dict (module docstring)."""
    probs = {case: synth.synthetic_problem(synth_seed, flags)
             for case, flags in cases}
    p0 = probs[cases[0][0]]
    out = {"provenance": {
        "generator": "hydra_pspec_torch/validation/oracle.py",
        "oracle": "NumPy copy of tests/reference_impl.py (reference "
                  "pspec.py semantics) in validation/oracle.py",
        "niter": niter, "nburn": nburn, "nchains": nchains, "seed": seed,
        "synth_seed": synth_seed,
        "data_sha256": synth.data_digest(p0.d),
        "data": f"validation/synth.py::synthetic_problem(seed={synth_seed})"
                f": {p0.d.shape[0]} times x {p0.d.shape[1]} channels, "
                f"{p0.fgmodes.shape[1]} Legendre modes, Ninv = 1",
        "prior": f"synth.make_prior(half={synth.PRIOR_HALF}): [truth/10, "
                 f"truth*10] over the +-{synth.PRIOR_HALF} delay-0 bins",
        "generated_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }}
    jobs = [(chain_seed(seed, c, flags is not None), niter, probs[case].d,
             probs[case].w, probs[case].ninv, probs[case].fgmodes,
             probs[case].eor_cov, probs[case].prior)
            for case, flags in cases for c in range(nchains)]
    t0 = time.perf_counter()
    with ProcessPoolExecutor(max_workers=workers) as ex:
        results = list(ex.map(_worker, jobs))
    wall = time.perf_counter() - t0
    for i, (case, flags) in enumerate(cases):
        res = results[i * nchains:(i + 1) * nchains]
        stats = case_stats(np.stack([r[0] for r in res]),
                           np.stack([r[1] for r in res]), nburn,
                           probs[case].dps_true(), flags)
        stats["wall_s"] = round(wall, 1)
        out[case] = stats
        print(f"[oracle] {case}: rhat_max={stats['split_rhat_max']} "
              f"chisq={stats['chisq_postburn_mean']} "
              f"min_ess={min(stats['ess_log_ps']):.0f} "
              f"wall={stats['wall_s']}s", file=sys.stderr)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--niter", type=int, default=NITER)
    p.add_argument("--nburn", type=int, default=NBURN)
    p.add_argument("--nchains", type=int, default=NCHAINS)
    p.add_argument("--seed", type=int, default=ORACLE_SEED)
    p.add_argument("--synth_seed", type=int, default=synth.SEED)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--out", default=str(OUT))
    args = p.parse_args(argv)
    out = build(args.niter, args.nburn, args.nchains, args.seed,
                args.synth_seed, args.workers)
    Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    print(f"[oracle] wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
