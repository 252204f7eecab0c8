"""Minimal use of the library API: one baseline's Gibbs chain through
``hydra_pspec_torch.gibbs_sample_with_fg`` (the complex float64 engine),
the port's counterpart of ``scripts/simple_example.py``.

The data are the synthetic problem of ``validation/synth.py``: one
baseline drawn from the model itself, d = s + Fg a + n, with a known EoR
power spectrum. The chain starts from the truth's covariance, with the
prior bounds of ``synth.make_prior`` and 12 Legendre foreground modes. It
prints chi^2 after burn-in (a correct sampler gives about 1) and the
median ratio of the recovered posterior-weighted power to the truth on
the EoR-dominated outer delay bins (about 1).

    python -m hydra_pspec_torch.scripts.simple_example [--niter 100]
        [--burn 30] [--device cuda] [--ntimes 203] [--nfreqs 120]
"""
import argparse

import numpy as np

from ..validation import synth


def edge_bins(nf):
    """The EoR-dominated outer delay bins (0:40 and 80:120 at 120
    channels, as the JAX example reads them)."""
    return np.r_[0:nf // 3, nf - nf // 3:nf]


def main(argv=None):
    """Run the chain and print its summary; returns it as a dict."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--niter", type=int, default=100)
    p.add_argument("--burn", type=int, default=30)
    p.add_argument("--seed", type=int, default=7123689,
                   help="the chain's Philox seed")
    p.add_argument("--data_seed", type=int, default=synth.SEED)
    p.add_argument("--ntimes", type=int, default=synth.NT)
    p.add_argument("--nfreqs", type=int, default=synth.NF)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from .. import gibbs_sample_with_fg

    prob = synth.synthetic_problem(args.data_seed, ntimes=args.ntimes,
                                   nf=args.nfreqs)
    ntimes, nfreqs = prob.d.shape
    print(f"synthetic baseline (seed {args.data_seed}): Ntimes={ntimes} "
          f"Nfreqs={nfreqs}, {prob.fgmodes.shape[1]} foreground modes")
    signal_cr, signal_S, signal_ps, fg_amps, chisq, ln_post, _ = \
        gibbs_sample_with_fg(prob.d, prob.w, prob.eor_cov, prob.fgmodes,
                             np.diag(prob.ninv), prob.prior,
                             Niter=args.niter, seed=args.seed,
                             verbose=False, device=args.device)
    print(f"signal_cr {signal_cr.shape}  signal_ps {signal_ps.shape}  "
          f"fg_amps {fg_amps.shape}")
    burn = min(args.burn, args.niter - 1)
    chi2 = float(np.mean(chisq[burn:]))
    pwm = np.average(signal_ps[burn:], weights=ln_post[burn:], axis=0)
    edge = edge_bins(nfreqs)
    ratio = float(np.median(pwm[edge] / prob.dps_true()[edge]))
    print(f"chi^2 (post burn-in) = {chi2:.4f}  (want ~1)")
    print(f"median recovered/true (EoR bins) = {ratio:.3f}  (want ~1)")
    return {"chi2": chi2, "ratio": ratio, "signal_ps": signal_ps,
            "finite": bool(np.isfinite(signal_ps).all()
                           and np.isfinite(signal_cr).all())}


if __name__ == "__main__":
    main()
