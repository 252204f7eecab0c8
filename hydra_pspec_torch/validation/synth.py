"""The synthetic problem of the port's checks, drawn from the model itself.

Data at the reference's shape (203 times x 120 channels, 12 Legendre
foreground modes) with a known power spectrum, so that a correct sampler's
posterior is known to hold the truth and its chi^2 is 1:

    d = s + Fg a + n,   s ~ CN(0, F^H diag(ps_truth / n^2) F),
    a ~ CN(0, diag(1e3 / (1 + mode))^2),   n ~ CN(0, 1 / Ninv).

:func:`make_jobs` draws baselines for the runner (``chip_smoke.py``'s
phases); :func:`synthetic_problem` returns one baseline with everything the
posterior oracle (``validation/oracle.py``) and the validation run
(``validation/validate.py``) need, all from one ``seed``.
"""
import hashlib
from dataclasses import dataclass

import numpy as np

SEED = 20261016
NT, NF, NM = 203, 120, 12     # reference shape (SURVEY.md:69, bench.py:54-61)
PRIOR_HALF = 3                # 7 prior bins around delay 0
CHI2_DENSE_RHO = 0.5          # dense noise: C_ij = s^2 rho^|i-j|
# the RFI-flag pattern of the flagged validation case
# (scripts/make_oracle_posterior.py:53)
FLAG_CHANNELS = "12,30-33,77-79,100"


def ps_truth(nf=NF):
    delay = np.arange(nf) - nf // 2
    return 1000.0 / (1.0 + (delay / 8.0) ** 2)


def noise_cov(b, nbl, nf=NF):
    """Baseline b's dense noise covariance C_ij = s^2 rho^|i-j|, s^2 from
    0.5 to 2 over the baselines: stationary noise correlated between
    neighbouring channels, the np.cov of the data that
    scripts/calc_vis_cov_matrices.py writes."""
    i = np.arange(nf)
    s2 = 0.5 + 1.5 * b / max(nbl - 1, 1)
    return s2 * CHI2_DENSE_RHO ** np.abs(i[:, None] - i[None, :])


def make_prior(half=PRIOR_HALF, nf=NF):
    """Bounds [truth / 10, truth x 10] over the 2 half + 1 central delay
    bins, the rest unbounded."""
    prior = np.zeros((2, nf))
    sl = slice(nf // 2 - half, nf // 2 + half + 1)
    prior[0, sl] = ps_truth(nf)[sl] * 10.0
    prior[1, sl] = ps_truth(nf)[sl] / 10.0
    return prior


def data_digest(d) -> str:
    """SHA-256 of the visibilities rounded to little-endian complex64: names
    a problem in an oracle's provenance. The float64 draws pass through
    BLAS products, whose last bits depend on the BLAS and its thread
    count; the rounding keeps the name of the same draws."""
    return hashlib.sha256(np.ascontiguousarray(
        d, dtype="<c8").tobytes()).hexdigest()


def fourier_matrix(nf):
    """The centred DFT F_kj = exp(-2 pi i k j / n), k, j from -n/2."""
    i = np.arange(nf) - nf // 2
    return np.exp(-2j * np.pi * np.outer(i, i) / nf)


def parse_flags(spec, nfreqs):
    """Channel weights from a comma list of channels and a-b ranges
    (0 = flagged)."""
    w = np.ones(nfreqs)
    if spec:
        for part in spec.split(","):
            if "-" in part:
                a, b = part.split("-")
                w[int(a): int(b) + 1] = 0
            else:
                w[int(part)] = 0
    return w


def _draw(nbl, ntimes, dense, seed, nf):
    """Per baseline (s, d, Ninv) in the order the generator draws them."""
    from ..cli.run import legendre_fgmodes

    rng = np.random.default_rng(seed)
    f = fourier_matrix(nf)
    amp = np.sqrt(ps_truth(nf) / nf**2)
    fg = legendre_fgmodes(nf, NM)
    cn = lambda *s: (rng.standard_normal(s)
                     + 1j * rng.standard_normal(s)) / np.sqrt(2)
    for b in range(nbl):
        s = (cn(ntimes, nf) * amp) @ f.conj()      # rows: F^H (amp z)
        a = cn(ntimes, NM) * 1e3 / (1.0 + np.arange(NM))
        if dense:
            c = noise_cov(b, nbl, nf)
            n, ninv = cn(ntimes, nf) @ np.linalg.cholesky(c).T, \
                np.linalg.inv(c)
        else:
            n, ninv = cn(ntimes, nf), np.ones(nf)
        yield s, s + a @ fg.T + n, ninv, fg


def make_jobs(nbl, out_root=None, ntimes=NT, dense=False, seed=SEED, nf=NF):
    """``nbl`` runner.BaselineJob of model-drawn data (module docstring),
    Ninv = 1; with ``dense``, n ~ CN(0, C) with C from :func:`noise_cov`
    and Ninv = C^-1, a dense matrix. ``nf`` channels; the chains start
    from S_initial = I."""
    from ..runner import BaselineJob

    return [BaselineJob(
        antpair=(b, b + 1), d=d, w=np.ones(nf), fgmodes=fg,
        S_initial=np.eye(nf), Ninv=ninv,
        out_dir=None if out_root is None else out_root / f"{b}-{b + 1}")
        for b, (_, d, ninv, fg) in enumerate(
            _draw(nbl, ntimes, dense, seed, nf))]


@dataclass
class Problem:
    """One baseline of the synthetic problem (:func:`synthetic_problem`)."""

    d: np.ndarray          # (ntimes, nf) complex
    w: np.ndarray          # (nf,) channel weights, 0 = flagged
    ninv: np.ndarray       # (nf,) diagonal inverse noise variance
    fgmodes: np.ndarray    # (nf, NM) Legendre modes
    eor_cov: np.ndarray    # (nf, nf) F^H diag(ps_truth / n^2) F
    prior: np.ndarray      # (2, nf) make_prior()
    s: np.ndarray          # (ntimes, nf) the EoR-only component of d
    ps_truth: np.ndarray   # (nf,)
    seed: int
    flag_channels: str | None

    def dps_true(self):
        """The truth spectrum from the EoR-only component
        (:func:`delay_spectrum`)."""
        return delay_spectrum(self.s)


def delay_spectrum(s):
    """The truth spectrum of an EoR-only component ``s`` (ntimes, nf), as
    scripts/validate_posterior.py:181-185 takes it from vis-eor.uvh5:
    mean over times of |centred FFT(s)|^2."""
    ds = np.fft.fftshift(np.fft.fft(np.fft.ifftshift(s, axes=1), axis=1),
                         axes=1)
    return (np.abs(ds) ** 2).mean(axis=0)


def eor_component(b, ntimes=NT, seed=SEED, nf=NF):
    """The EoR-only component s (ntimes, nf) of baseline ``b`` of
    ``make_jobs(..., ntimes=ntimes, seed=seed, nf=nf)``: the truth of its
    visibilities (their vis-eor.uvh5)."""
    for s, _, _, _ in _draw(b + 1, ntimes, False, seed, nf):
        pass
    return s


def eor_covariance(nf=NF):
    """F^H diag(ps_truth / n^2) F: the signal covariance of the truth (the
    reference's eor-cov.npy)."""
    f = fourier_matrix(nf)
    return f.conj().T @ (ps_truth(nf)[:, None] / nf**2 * f)


def synthetic_problem(seed=SEED, flag_channels=None, ntimes=NT, nf=NF):
    """Baseline 0 of ``make_jobs(1, seed=seed)`` with the flag pattern
    ``flag_channels`` (a :func:`parse_flags` spec or None), the prior of
    :func:`make_prior` and the EoR covariance of the truth."""
    s, d, ninv, fg = next(_draw(1, ntimes, False, seed, nf))
    return Problem(d=d, w=parse_flags(flag_channels, nf), ninv=ninv,
                   fgmodes=fg, eor_cov=eor_covariance(nf),
                   prior=make_prior(nf=nf),
                   s=s, ps_truth=ps_truth(nf), seed=seed,
                   flag_channels=flag_channels)
