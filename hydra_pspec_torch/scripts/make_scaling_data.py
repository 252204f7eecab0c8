"""N baselines of the synthetic problem as a uvh5 file plus the
per-baseline aux arrays the CLI reads: the port's counterpart of
``scripts/make_scaling_data.py``, which copied one baseline of the
reference's test data N times.

The baselines are ``validation/synth.py::make_jobs(n)``: each its own
draw from the model (noise included in the visibilities, inverse noise
variance 1). Each baseline's runs are keyed on its global id, so the
scaling oracle is not that baselines agree with each other: every process
count and device count must write the files of one process on one device
(``scaling_test``).

    python -m hydra_pspec_torch.scripts.make_scaling_data --n 16 \
        --out scaling-data/ [--ntimes 203] [--nfreqs 120] [--seed S]

writes ``scaling-data/vis.uvh5`` and ``scaling-data/aux/<a>-<b>/``
``noise-cov.npy`` (the identity), ``fgmodes.npy`` (the 12 Legendre modes
of the draw) and ``eor-cov.npy`` (the truth's covariance, the chains'
start). Run the CLI on them with

    python -m hydra_pspec_torch.cli.run scaling-data/vis.uvh5 \
        --noise_cov scaling-data/aux --noise_cov_file noise-cov.npy \
        --fgmodes scaling-data/aux --fgmodes_file fgmodes.npy \
        --sigcov0 scaling-data/aux --sigcov0_file eor-cov.npy \
        --Nfgmodes 12 --Niter 4 --seed 7123689 --out_dir out/

Writing uvh5 needs h5py.
"""
import argparse
from pathlib import Path

import numpy as np

from ..utils.uvh5 import write_uvh5
from ..validation import synth

FREQ0_HZ, DFREQ_HZ = 1.0e8, 97.65625e3   # HERA's channel width


def main(argv=None):
    """Write the data; returns the jobs they hold."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=8, help="number of baselines")
    p.add_argument("--out", default="./scaling-data")
    p.add_argument("--ntimes", type=int, default=synth.NT)
    p.add_argument("--nfreqs", type=int, default=synth.NF)
    p.add_argument("--seed", type=int, default=synth.SEED)
    args = p.parse_args(argv)

    out = Path(args.out)
    (out / "aux").mkdir(parents=True, exist_ok=True)
    jobs = synth.make_jobs(args.n, ntimes=args.ntimes, seed=args.seed,
                           nf=args.nfreqs)
    nf = args.nfreqs
    write_uvh5(out / "vis.uvh5", {j.antpair: j.d for j in jobs},
               FREQ0_HZ + DFREQ_HZ * np.arange(nf))
    eor_cov = synth.eor_covariance(nf)
    for j in jobs:
        d = out / "aux" / f"{j.antpair[0]}-{j.antpair[1]}"
        d.mkdir(exist_ok=True)
        np.save(d / "noise-cov.npy", np.diag(1.0 / np.asarray(j.Ninv)))
        np.save(d / "fgmodes.npy", j.fgmodes)
        np.save(d / "eor-cov.npy", eor_cov)
    print(f"wrote {args.n} baselines ({args.ntimes} times x {nf} channels) "
          f"to {out}/vis.uvh5 and their aux dirs")
    return jobs


if __name__ == "__main__":
    main()
