"""The recovered EoR delay power spectrum against the truth: the port's
counterpart of ``scripts/plot_test_data_results.py`` (the reference's
test_data/plot-test-data-results.py): the posterior-weighted mean and the
percentile band of ``dps-eor.npy`` against the truth, and how many bins
hold the truth inside the band.

    python -m hydra_pspec_torch.scripts.plot_test_data_results \
        --res-dir out/res/0-1 [--baseline 0] [--nburn 100] \
        [--conf-interval 95] [--save plot.png] [--vis-eor vis-eor.uvh5]

The truth is the EoR-only component of synthetic baseline ``--baseline``
(``validation/synth.py``: ``make_jobs``'s draws, with ``--ntimes``,
``--nfreqs`` and ``--data_seed`` as the data were made, as by
``make_scaling_data``), or with ``--vis-eor`` the first baseline of a
uvh5 file of EoR-only visibilities (h5py). The numbers are printed; the
plot is drawn with matplotlib only when ``--save`` is given.
"""
import argparse
from pathlib import Path

import numpy as np

from ..validation import synth
from .make_scaling_data import DFREQ_HZ


def delay_array(nfreqs, dfreq_hz):
    """fftshifted delays for channel width ``dfreq_hz`` (the JAX package's
    ``ops/fourier.py::delay_array``)."""
    return np.fft.fftshift(np.fft.fftfreq(nfreqs, d=dfreq_hz * 1e-9))


def main(argv=None):
    """Print the summary (and save the plot); returns the summary."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--res-dir", required=True)
    p.add_argument("--baseline", type=int, default=0)
    p.add_argument("--ntimes", type=int, default=synth.NT)
    p.add_argument("--nfreqs", type=int, default=synth.NF)
    p.add_argument("--data_seed", type=int, default=synth.SEED)
    p.add_argument("--vis-eor", default=None)
    p.add_argument("--conf-interval", type=int, default=95)
    p.add_argument("--nburn", type=int, default=0)
    p.add_argument("--save", default=None, help="write a PNG there")
    args = p.parse_args(argv)

    if args.vis_eor:
        from ..utils.uvh5 import read_uvh5

        bls, freqs = read_uvh5(args.vis_eor)
        s, df = bls[0].vis, freqs[1] - freqs[0]
    else:
        s = synth.eor_component(args.baseline, ntimes=args.ntimes,
                                seed=args.data_seed, nf=args.nfreqs)
        df = DFREQ_HZ
    dps_true = synth.delay_spectrum(s)
    nfreqs = dps_true.size
    res = Path(args.res_dir)
    dps = np.load(res / "dps-eor.npy")[args.nburn:]
    ln_post = np.load(res / "ln-post.npy")[args.nburn:]
    pwm = np.average(dps, weights=ln_post, axis=0)
    pc = args.conf_interval / 2 + 50
    ub = np.percentile(dps, pc, axis=0)
    lb = np.percentile(dps, 100 - pc, axis=0)
    inside = int(((dps_true >= lb) & (dps_true <= ub)).sum())
    ratio = float(np.median(pwm / dps_true))
    print(f"bins with truth inside {args.conf_interval}% CI: "
          f"{inside}/{nfreqs}")
    print(f"median recovered/true ratio: {ratio:.4f}")
    if args.save:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        delays = delay_array(nfreqs, df)
        fig, ax = plt.subplots(figsize=(12, 5))
        ax.plot(delays, dps_true, "k:", label="True")
        ax.errorbar(delays, pwm, yerr=np.vstack([pwm - lb, ub - pwm]),
                    color="k", ls="", marker="o", capsize=3,
                    label=f"Recovered ({args.conf_interval}% Confidence)")
        ax.legend(loc="upper right")
        ax.set_xlabel(r"$\tau$ [ns]")
        ax.set_ylabel(r"$P(\tau)$ [arb. units]")
        ax.set_title("EoR Delay Power Spectrum Comparison")
        ax.set_yscale("log")
        ax.grid()
        fig.tight_layout()
        fig.savefig(args.save, dpi=120)
        print(f"wrote {args.save}")
    return {"inside": inside, "nbins": nfreqs, "ratio": ratio, "pwm": pwm,
            "dps_true": dps_true}


if __name__ == "__main__":
    main()
