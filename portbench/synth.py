"""Seeded synthetic visibilities of one deployment, in NumPy.

A frozen copy of the model the program's own checks draw from
(``validation/synth.py``), so that a later change to the program cannot
move the benchmark's data:

    d = s + Fg a + n,   s ~ CN(0, F^H diag(ps_truth / n^2) F),
    a ~ CN(0, diag(1e3 / (1 + mode))^2),   n ~ CN(0, 1 / Ninv),

with ``ps_truth(delay) = 1000 / (1 + (delay / 8)^2)``, Legendre foreground
modes on the band and a diagonal Ninv of the configuration's ``ninv`` (1 in
the program's checks). Baseline ``b``'s draws are the ``b``-th of
one generator seeded from the run seed, so a cell with more baselines
holds a cell with fewer as its first ones.

Time flags come from the traffic file: rectangles of (times, channels)
flagged on every baseline, with RFI of a fixed amplitude added to the
flagged entries (a satellite pass, a transmitter's channel).
"""
import numpy as np
from numpy.polynomial import legendre

FG_AMPLITUDE = 1.0e3


def ps_truth(nf: int):
    delay = np.arange(nf) - nf // 2
    return 1000.0 / (1.0 + (delay / 8.0) ** 2)


def prior(nf: int, half: int, factor: float):
    """Bounds ``[truth / factor, truth * factor]`` over the ``2 half + 1``
    central delay bins; (2, nf) with row 0 the upper, row 1 the lower."""
    out = np.zeros((2, nf))
    sl = slice(nf // 2 - half, nf // 2 + half + 1)
    out[0, sl] = ps_truth(nf)[sl] * factor
    out[1, sl] = ps_truth(nf)[sl] / factor
    return out


def fourier_matrix(nf: int):
    i = np.arange(nf) - nf // 2
    return np.exp(-2j * np.pi * np.outer(i, i) / nf)


def legendre_modes(nf: int, nmodes: int):
    x = np.linspace(-1.0, 1.0, nf)
    return np.stack([legendre.legval(x, np.eye(nmodes)[i])
                     for i in range(nmodes)], axis=1)


def baselines(nbl: int, ntimes: int, nf: int, nmodes: int, seed: int,
              ninv: float = 1.0):
    """``[(d, fgmodes, ninv), ...]`` of ``nbl`` baselines, the noise of
    variance ``1 / ninv`` in every channel."""
    rng = np.random.default_rng(seed)
    f = fourier_matrix(nf)
    amp = np.sqrt(ps_truth(nf) / nf ** 2)
    fg = legendre_modes(nf, nmodes)
    cn = lambda *s: (rng.standard_normal(s)
                     + 1j * rng.standard_normal(s)) / np.sqrt(2)
    out = []
    for _ in range(nbl):
        s = (cn(ntimes, nf) * amp) @ f.conj()
        a = cn(ntimes, nmodes) * FG_AMPLITUDE / (1.0 + np.arange(nmodes))
        n = cn(ntimes, nf) / np.sqrt(ninv)
        out.append((s + a @ fg.T + n, fg, np.full(nf, ninv)))
    return out


def time_flags(windows, ntimes: int, nf: int):
    """(ntimes, nf) bool from ``[{"times": [t0, t1], "channels": [c0,
    c1]}, ...]`` (half-open ranges), or None without windows."""
    if not windows:
        return None
    f = np.zeros((ntimes, nf), dtype=bool)
    for w in windows:
        (t0, t1), (c0, c1) = w["times"], w["channels"]
        f[t0:t1, c0:c1] = True
    return f
