"""Pieces of the command-line driver that the library path needs (port of
``hydra_pspec_tpu/cli/run.py:97-193``). The CLI itself (uvh5 reading with
h5py, YAML configs) is not ported yet: ROADMAP.md, Queue 1 item 5."""
import numpy as np


def legendre_fgmodes(nfreqs: int, nmodes: int) -> np.ndarray:
    """Legendre-polynomial foreground basis (reference
    run-hydra-pspec.py:456-460)."""
    from numpy.polynomial import legendre

    x = np.linspace(-1.0, 1.0, nfreqs)
    cols = []
    for i in range(nmodes):
        c = np.zeros(i + 1)
        c[i] = 1.0
        cols.append(legendre.legval(x, c))
    return np.stack(cols, axis=1)


def build_prior(cfg, nfreqs: int) -> np.ndarray:
    """Prior window around delay 0 (reference run-hydra-pspec.py:504-517).
    ``cfg`` carries ``ps_prior_lo``, ``ps_prior_hi`` and
    ``n_ps_prior_bins``."""
    prior = np.zeros((2, nfreqs))
    if cfg.ps_prior_lo != 0 or cfg.ps_prior_hi != 0:
        sl = slice(nfreqs // 2 - cfg.n_ps_prior_bins,
                   nfreqs // 2 + cfg.n_ps_prior_bins + 1)
        prior[0, sl] = cfg.ps_prior_hi
        prior[1, sl] = cfg.ps_prior_lo
    return prior
