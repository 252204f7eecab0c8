"""Monte-Carlo-error-aware posterior comparison statistics (the port's
copy of ``hydra_pspec_tpu/utils/mcstats.py``, numpy only: the JAX package's
``__init__`` imports JAX, which the card's machine does not have).

Effective sample size (ESS) per delay bin, and a per-bin z-comparison of a
run's posterior against a long-run oracle posterior
(``validation/oracle_posterior_synth.json``, written by
``validation/oracle.py`` from the NumPy oracle of the reference algorithm).
"""
from __future__ import annotations

import numpy as np


def ess_geyer(chains: np.ndarray) -> float:
    """Effective sample size per Stan/Geyer (initial monotone positive
    pair sequence) for (nchains, ndraws) draws of one scalar quantity."""
    m, nd = chains.shape
    x = chains - chains.mean(axis=1, keepdims=True)
    # per-chain autocovariance via FFT
    nfft = int(2 ** np.ceil(np.log2(2 * nd)))
    f = np.fft.rfft(x, n=nfft, axis=1)
    acov = np.fft.irfft(f * f.conj(), n=nfft, axis=1)[:, :nd].real / nd
    chain_var = acov[:, 0] * nd / (nd - 1.0)
    w_mean = chain_var.mean()
    if m > 1:
        between = chains.mean(axis=1).var(ddof=1)
        var_plus = w_mean * (nd - 1.0) / nd + between
    else:
        var_plus = w_mean * (nd - 1.0) / nd
    if var_plus <= 0:
        return float(m * nd)
    rho = 1.0 - (w_mean - acov.mean(axis=0)) / var_plus
    rho[0] = 1.0
    # Geyer pairs Γ_k = ρ_{2k} + ρ_{2k+1} (Stan formulation, including
    # ρ_0): initial positive sequence, then monotone decrease; τ = -1 +
    # 2 Σ Γ_k. Unlike the (ρ_1+ρ_2)-pairing this does not floor τ at 1,
    # so antithetic chains can correctly report ESS > N.
    t = 0
    pair_sums = []
    while t + 1 < nd:
        s = rho[t] + rho[t + 1]
        if s <= 0:
            break
        pair_sums.append(s)
        t += 2
    # initial monotone sequence
    for i in range(1, len(pair_sums)):
        pair_sums[i] = min(pair_sums[i], pair_sums[i - 1])
    tau = -1.0 + 2.0 * sum(pair_sums)
    return float(m * nd / max(tau, 1.0 / (m * nd)))


def compare_to_oracle(ps_chains: np.ndarray, oracle: dict,
                      eps_log: float = 0.02) -> dict:
    """Per-delay-bin MC-error-aware comparison of post-burn bandpower
    draws against the oracle posterior statistics.

    ps_chains: (nchains, ndraws, nbins) post-burn bandpower samples.
    oracle: one case dict of an oracle artifact
            (mean_log_ps / sd_log_ps / ess_log_ps / q5_ps / q95_ps).
    eps_log: absolute log-space tolerance treated as scientifically
             negligible (0.02 = 2% in power; the old truth-bracketing
             window hid ~15-20% biases).

    z_k = |Δ mean log ps_k| / sqrt(sd_ours²/ESS_ours + sd_orc²/ESS_orc);
    a bin counts as discrepant only if BOTH z_k exceeds the z threshold
    AND |Δ| > eps_log.
    """
    logp = np.log(np.maximum(ps_chains, 1e-300))
    nbins = logp.shape[2]
    mean_ours = logp.mean(axis=(0, 1))
    sd_ours = logp.reshape(-1, nbins).std(axis=0, ddof=1)
    ess_ours = np.array([ess_geyer(logp[:, :, k]) for k in range(nbins)])
    q50_ours = np.median(ps_chains.reshape(-1, nbins), axis=0)

    mean_orc = np.asarray(oracle["mean_log_ps"])
    sd_orc = np.asarray(oracle["sd_log_ps"])
    ess_orc = np.asarray(oracle["ess_log_ps"])
    q5_orc = np.asarray(oracle["q5_ps"])
    q95_orc = np.asarray(oracle["q95_ps"])

    delta = mean_ours - mean_orc
    mc_sd = np.sqrt(sd_ours**2 / np.maximum(ess_ours, 1.0)
                    + sd_orc**2 / np.maximum(ess_orc, 1.0))
    z = np.abs(delta) / np.maximum(mc_sd, 1e-12)
    material = np.abs(delta) > eps_log          # beyond numerical noise
    z_eff = np.where(material, z, 0.0)
    in_ci = (q50_ours >= q5_orc) & (q50_ours <= q95_orc)

    return {
        "max_z": round(float(z_eff.max()), 3),
        "argmax_z_bin": int(z_eff.argmax()),
        "n_z_gt3": int((z_eff > 3.0).sum()),
        "max_abs_dlog": round(float(np.abs(delta).max()), 4),
        "median_abs_dlog": round(float(np.median(np.abs(delta))), 4),
        "min_ess_ours": round(float(ess_ours.min()), 1),
        "median_ess_ours": round(float(np.median(ess_ours)), 1),
        "ci_cover_frac": round(float(in_ci.mean()), 4),
        "eps_log": eps_log,
    }


def oracle_acceptance(cmp: dict, max_z: float = 4.5,
                      max_n_z_gt3: int = 5,
                      min_ci_cover: float = 0.95) -> bool:
    """The pass predicate on a compare_to_oracle result. With ~120 bins,
    P(max z > 4.5 | correct sampler) ≈ 8e-4 and E[#(z>3)] ≈ 0.3, so these
    bounds are quiet for a correct engine yet a 15% bias (|Δlog| 0.14
    against MC errors ~1e-2) fails them by an order of magnitude."""
    return bool(cmp["max_z"] < max_z
                and cmp["n_z_gt3"] <= max_n_z_gt3
                and cmp["ci_cover_frac"] >= min_ci_cover)
