"""The plain reference of one Gibbs iteration of the bandpower sampler, in
NumPy: the reference ``hydra-pspec`` semantics (``pspec.py``: the
constrained-realization block system of signal and foreground amplitudes,
then the inverse-gamma bandpower draw), worked out from the baseline's
data, flags, foreground modes and noise alone.

One iteration of chain ``(baseline, chain)`` at iteration ``g``, from the
bandpowers ``ps`` it starts from:

* per time group (one group without time flags; else the times sharing a
  flag row, with that row's channel weights ``w``): the signal ``s`` and
  foreground amplitudes ``a`` of every time solve

      [I + S Ni      S Ni Fg  ] [s]   [S Ni d + S^1/2 oa + S Ni^1/2 ob]
      [Fg^H Ni    Fg^H Ni Fg ] [a] = [Fg^H (Ni d + Ni^1/2 ob)        ]

  with ``S = F^H diag(ps / n^2) F`` (``F`` the centred DFT), ``Ni = w
  Ninv w``, ``d`` the weighted visibilities, ``oa`` and ``ob`` standard
  complex normals (``reference/philox.py``: the stream's delay-basis field
  is ``F oa``);
* ``beta = sum_t |F s_t|^2`` pooled over the groups, ``alpha = Ntimes - 1``;
  free bins ``beta / Gamma(alpha)``, bounded bins the inverse-gamma at
  ``alpha + 1`` truncated to the prior, drawn by inverting ``Q(alpha + 1,
  beta / x)`` through a table of it on a log grid;
* ``chisq``: the mean over every (time, channel) of ``|d - s - Fg a|^2
  Ninv``; ``ln_post = -(sum Ni |d - s - Fg a|^2 + sum_k sum_t |F (w
  s_t)|_k^2 / ps_new_k)``.

``precision="tf32"`` computes the same in float32 with every matrix
product's operands rounded to TF32 (10 mantissa bits, as the tensor cores
read them): the control, which the comparison must refuse.
"""
from typing import NamedTuple

import numpy as np
from scipy.special import gammaincc

from . import philox

TABLE_SIZE, TABLE_TAIL = 4096, 60.0


def fourier_matrix(n: int):
    i = np.arange(n) - n // 2
    return np.exp(-2j * np.pi * np.outer(i, i) / n)


def tf32(x):
    """Round a complex64 or float32 array to TF32 (nearest, ties away)."""
    x = np.asarray(x)
    if np.iscomplexobj(x):
        return (tf32(x.real) + 1j * tf32(x.imag)).astype(np.complex64)
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


class Precision(NamedTuple):
    cdt: type
    rdt: type
    round_products: bool

    def mm(self, a, b):
        if self.round_products:
            return tf32(a) @ tf32(b)
        return a @ b


PRECISIONS = {"fp64": Precision(np.complex128, np.float64, False),
              "tf32": Precision(np.complex64, np.float32, True)}


class Group(NamedTuple):
    idx: np.ndarray      # the group's time indices, increasing
    w: np.ndarray        # (n,) channel weights, 1 = kept


class Baseline(NamedTuple):
    vis: np.ndarray      # (Ntimes, n) complex visibilities
    fg: np.ndarray       # (n, m) foreground modes
    ninv: np.ndarray     # (n,) diagonal inverse noise variance
    groups: tuple        # Group per flag row, in order of first appearance


def flag_groups(flags, ntimes: int, n: int) -> tuple:
    """Times grouped by identical flag row (True = flagged), in order of
    first appearance; one group of every time without flags."""
    if flags is None:
        return (Group(np.arange(ntimes), np.ones(n)),)
    flags = np.asarray(flags, dtype=bool)
    _, first, inverse = np.unique(flags, axis=0, return_index=True,
                                  return_inverse=True)
    inverse = inverse.reshape(-1)
    return tuple(Group(np.nonzero(inverse == u)[0],
                       (~flags[np.nonzero(inverse == u)[0][0]]).astype(float))
                 for u in np.argsort(first))


def invgamma_table(alpha: float):
    """``(log y, Q(alpha, y))`` on a log grid over ``[alpha / 1e4, alpha +
    60 sqrt(alpha) + 10]``."""
    lo = max(alpha / 1e4, 1e-30)
    hi = alpha + TABLE_TAIL * np.sqrt(max(alpha, 1.0)) + 10.0
    y = np.logspace(np.log10(lo), np.log10(hi), TABLE_SIZE)
    return np.log(y), gammaincc(alpha, y)


def _q_at(log_y, q, y):
    ly = np.log(np.maximum(y, np.finfo(float).tiny))
    i = np.clip(np.searchsorted(log_y, ly), 1, len(log_y) - 1)
    t = np.clip((ly - log_y[i - 1]) / (log_y[i] - log_y[i - 1]), 0.0, 1.0)
    return q[i - 1] + t * (q[i] - q[i - 1])


def _y_at(log_y, q, c):
    s = len(q)
    i = np.clip(np.sum(q[None, :] < np.atleast_1d(c)[:, None], axis=1),
                1, s - 1)
    j0, j1 = s - i, s - 1 - i
    t = np.clip((c - q[j0]) / np.maximum(q[j1] - q[j0], 1e-30), 0.0, 1.0)
    return np.exp(log_y[j0] + t * (log_y[j1] - log_y[j0]))


def bounded_bins(prior):
    """Bounded bins of a (2, n) prior (either bound > 0): idx, lo, hi."""
    idx = np.nonzero(np.any(np.asarray(prior) > 0, axis=0))[0]
    return idx, prior[1, idx], prior[0, idx]


def bandpowers(beta, gam, u, prior, table):
    """Free bins ``beta / gam``; bounded bins the truncated inverse gamma
    at ``u`` through ``table``."""
    out = beta / gam
    idx, lo, hi = bounded_bins(prior)
    if idx.size:
        log_y, q = table
        b = beta[idx]
        p_lo, p_hi = _q_at(log_y, q, b / lo), _q_at(log_y, q, b / hi)
        y = _y_at(log_y, q, p_lo + u[:idx.size] * (p_hi - p_lo))
        out[idx] = np.clip(b / np.maximum(y, np.finfo(float).tiny), lo, hi)
    return out


def initial_bandpowers(S_initial):
    """The chain's first state from an initial covariance: the diagonal of
    ``F S F^H`` (``S`` given as a matrix, or its bandpowers)."""
    S0 = np.asarray(S_initial)
    if S0.ndim == 1:
        return np.clip(S0.real, 0.0, None)
    F = fourier_matrix(S0.shape[0])
    return np.clip(np.diagonal(F @ S0 @ F.conj().T).real, 0.0, None)


class Randomness(NamedTuple):
    oa: list        # per group (n, lanes) delay-basis omegas
    ob: list        # per group (n, lanes) channel-basis omegas
    gam: np.ndarray
    u: np.ndarray


def randomness(bl: Baseline, seed: int, sid: int, g: int, nbounded: int):
    """The iteration's random numbers of chain stream ``sid``."""
    n = bl.vis.shape[1]
    G = len(bl.groups)
    rows = ([sid] if G == 1 else
            [sid * philox.key_group(G) + k for k in range(G)])
    chain = sid if G == 1 else sid + philox.CHAIN_STREAM_OFFSET
    fields = [philox.omegas(seed, r, g, n, len(grp.idx), n)
              for r, grp in zip(rows, bl.groups)]
    alpha = bl.vis.shape[0] - 1
    return Randomness([f[0] for f in fields], [f[1] for f in fields],
                      philox.gamma(seed, chain, g, n, alpha),
                      philox.prior_uniforms(seed, chain, g, nbounded))


def step(bl: Baseline, ps, rnd: Randomness, prior, table,
         precision: str = "fp64") -> dict:
    """One iteration from ``ps``: ``{"ps", "beta", "chisq", "ln_post",
    "noise", "bmask"}`` (``beta`` the pooled delay power the bandpowers are
    drawn from; ``noise`` and ``bmask`` the two parts of ``ln_post``)."""
    P = PRECISIONS[precision]
    ntimes, n = bl.vis.shape
    m = bl.fg.shape[1]
    F = fourier_matrix(n).astype(P.cdt)
    Fh = F.conj().T
    fg = bl.fg.astype(P.cdt)
    ps = np.asarray(ps, dtype=np.float64)
    S = P.mm(Fh, (ps[:, None] / n ** 2 * F).astype(P.cdt))
    Sh = P.mm(Fh, (np.sqrt(ps)[:, None] / n ** 1.5 * F).astype(P.cdt))
    beta = np.zeros(n)
    bmask = np.zeros(n)
    noise = chi = 0.0
    for grp, oa_d, ob in zip(bl.groups, rnd.oa, rnd.ob):
        d = (bl.vis[grp.idx] * grp.w).astype(P.cdt)            # (T, n)
        ni = (bl.ninv * grp.w * grp.w).astype(P.rdt)
        oa = P.mm(Fh, oa_d.astype(P.cdt)).T / n                # (T, n)
        ob = ob.T.astype(P.cdt)
        SNi = S * ni[None, :]
        SNih = S * np.sqrt(ni)[None, :]
        fgh_ni = fg.conj().T * ni[None, :]
        A = np.zeros((n + m, n + m), dtype=P.cdt)
        A[:n, :n] = np.eye(n) + SNi
        A[:n, n:] = P.mm(SNi, fg)
        A[n:, :n] = fgh_ni
        A[n:, n:] = P.mm(fgh_ni, fg)
        top = P.mm(d, SNi.T) + P.mm(oa, Sh.T) + P.mm(ob, SNih.T)
        bot = P.mm(d * ni[None, :] + ob * np.sqrt(ni)[None, :], fg.conj())
        X = np.linalg.solve(A, np.concatenate([top, bot], axis=1).T)
        s, a = X[:n].T, X[n:].T
        sk = P.mm(s, F.T)
        skm = P.mm(s * grp.w[None, :].astype(P.rdt), F.T)
        beta += np.sum(np.abs(sk) ** 2, axis=0)
        bmask += np.sum(np.abs(skm) ** 2, axis=0)
        r2 = np.abs(d - s - P.mm(a, fg.T)) ** 2
        noise += float(np.sum(r2 * ni[None, :]))
        chi += float(np.sum(r2 * bl.ninv[None, :]))
    new = bandpowers(beta, rnd.gam, rnd.u, prior, table)
    return {"ps": new, "beta": beta, "chisq": chi / (n * ntimes),
            "ln_post": ln_post(noise, bmask, new), "noise": noise,
            "bmask": bmask}


def ln_post(noise, bmask, ps):
    """``-(sum Ni |r|^2 + sum_k bmask_k / ps_k)``."""
    tiny = np.finfo(np.float32).tiny
    return -(noise + float(np.sum(bmask / np.maximum(ps, tiny))))
