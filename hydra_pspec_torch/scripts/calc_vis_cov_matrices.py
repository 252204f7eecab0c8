"""Per-baseline covariance and foreground eigenmodes: the port's
counterpart of ``scripts/calc_vis_cov_matrices.py`` (the reference's
scripts/calc-vis-cov-matrices.py:182-249). For each baseline, the
time-averaged frequency-frequency covariance ``np.cov(d.T)`` and,
optionally, its eigenvectors (the PCA foreground basis the CLI reads as
``fgmodes``, by default ``evecs-{freq_str}.npy``), plus a metadata record.

    python -m hydra_pspec_torch.scripts.calc_vis_cov_matrices \
        [data.uvh5 ...] --out-dir prep/ [--eig] [--ant-str 0_1,0_3] \
        [--freq-range 100-120] [--n 3]

The baselines are read from the uvh5 files (with h5py) when any are
given; otherwise they are ``--n`` baselines of the synthetic problem
(``validation/synth.py``), with the channels of ``make_scaling_data``.
"""
import argparse
from pathlib import Path

import numpy as np

from ..utils.provenance import get_git_version_info
from ..utils.uvh5 import BaselineData, parse_ant_str, read_uvh5
from ..validation import synth
from .make_scaling_data import DFREQ_HZ, FREQ0_HZ


def synthetic_baselines(n, ntimes=synth.NT, nf=synth.NF, seed=synth.SEED):
    """``n`` baselines of ``synth.make_jobs`` as :class:`BaselineData`
    (no uvh5 file), and their frequencies in Hz."""
    jobs = synth.make_jobs(n, ntimes=ntimes, seed=seed, nf=nf)
    freqs = FREQ0_HZ + DFREQ_HZ * np.arange(nf)
    times = 2459000.0 + np.arange(ntimes) / 86400.0
    lsts = np.linspace(0, 2 * np.pi * ntimes / 86400, ntimes)
    return [BaselineData(antpair=j.antpair, vis=j.d,
                         flags=np.zeros(j.d.shape, dtype=bool),
                         nsamples=np.ones(j.d.shape), freqs=freqs,
                         times=times, lsts=lsts, uvw=np.zeros((0, 3)))
            for j in jobs], freqs


def main(argv=None):
    """Write every baseline's covariance (and eigenmodes); returns
    ``{(a, b): cov}``."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("files", nargs="*")
    p.add_argument("--out-dir", default="./cov-prep")
    p.add_argument("--eig", action="store_true",
                   help="also write eigenvectors (the fgmodes PCA basis)")
    p.add_argument("--ant-str", default="cross")
    p.add_argument("--freq-range", default=None)
    p.add_argument("--n", type=int, default=3,
                   help="synthetic baselines when no file is given")
    args = p.parse_args(argv)

    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    if args.files:
        antpairs = parse_ant_str(args.ant_str)
        sets = [read_uvh5(fp, antpairs=antpairs, freq_range=args.freq_range)
                for fp in args.files]
    else:
        sets = [synthetic_baselines(args.n)]
    covs = {}
    for bls, freqs in sets:
        fmhz = np.asarray(freqs) / 1e6
        freq_str = f"{fmhz.min():.3f}-{fmhz.max():.3f}MHz"
        # the run's metadata with the reference's keys
        # (calc-vis-cov-matrices.py:225-231): git, args, freqs (Hz), lsts
        # (hours), uvws (a row a baseline), bls
        meta = {
            "git": get_git_version_info(),
            "args": vars(args),
            "freqs": np.asarray(freqs, dtype=float),
            "lsts": np.unique(np.concatenate([bl.lsts for bl in bls]))
            * 12.0 / np.pi,
            "uvws": np.stack([bl.uvw[0] if bl.uvw.size else np.zeros(3)
                              for bl in bls]),
            "bls": [bl.antpair for bl in bls],
        }
        np.save(out / "metadata-dict.npy", meta, allow_pickle=True)
        for bl in bls:
            a, b = bl.antpair
            d = out / f"{a}-{b}"
            d.mkdir(exist_ok=True)
            cov = np.cov(bl.vis.T)   # (Nfreqs, Nfreqs), time-averaged
            np.save(d / f"cov-{freq_str}.npy", cov)
            if args.eig:
                vals, vecs = np.linalg.eig(cov)
                order = np.argsort(-np.abs(vals))
                np.save(d / f"evals-{freq_str}.npy", vals[order])
                np.save(d / f"evecs-{freq_str}.npy", vecs[:, order])
            covs[(a, b)] = cov
            print(f"{a}-{b}: cov {cov.shape}"
                  + (" + eigenmodes" if args.eig else ""))
    return covs


if __name__ == "__main__":
    main()
