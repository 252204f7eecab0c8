"""Tabulated truncated inverse-gamma sampling.

Port of ``hydra_pspec_tpu/ops/invgamma.py:81-160``. The table of the
regularized upper gamma ``Q(alpha, y)`` on a log-spaced ``y`` grid is built
once on the host in float64 with scipy and stored in float32, as the JAX
package does. The lookups below are plain torch and serve as the reference
semantics of the bandpower kernel (``ops/kernels/rng_bandpower.py``).
"""
from typing import NamedTuple

import numpy as np
import torch

from . import philox


class InvGammaTable(NamedTuple):
    """``Q(alpha, y)`` on a log-spaced ``y`` grid (host numpy, float32)."""

    log_y: np.ndarray   # (size,) increasing
    q: np.ndarray       # (size,) Q(alpha, y), non-increasing in y
    alpha: np.ndarray   # () recorded for provenance


def make_invgamma_table(alpha: float, size: int = 4096, tail: float = 60.0,
                        dtype=np.float32) -> InvGammaTable:
    """Host-side table covering ``y`` in
    ``[alpha / 1e4, alpha + tail * sqrt(alpha) + 10]``; the sampler clamps
    outside it, where Q has saturated to 1 or 0."""
    from scipy.special import gammaincc

    a = float(alpha)
    lo = max(a / 1e4, 1e-30)
    hi = a + tail * np.sqrt(max(a, 1.0)) + 10.0
    y = np.logspace(np.log10(lo), np.log10(hi), size)
    q = gammaincc(a, y)
    return InvGammaTable(
        log_y=np.asarray(np.log(y), dtype=dtype),
        q=np.asarray(q, dtype=dtype),
        alpha=np.asarray(a, dtype=dtype),
    )


def table_q_at(log_y: torch.Tensor, q: torch.Tensor, y: torch.Tensor):
    """Q(alpha, y) by linear interpolation in log y, clamped at the ends.
    ``log_y``/``q`` are the (S,) table rows on ``y``'s device."""
    tiny = torch.finfo(y.dtype).tiny
    ly = torch.log(torch.clamp(y, min=tiny))
    s = log_y.shape[0]
    idx = torch.clamp(torch.searchsorted(log_y, ly.contiguous()), 1, s - 1)
    l0, l1 = log_y[idx - 1], log_y[idx]
    q0, q1 = q[idx - 1], q[idx]
    t = torch.clamp((ly - l0) / torch.clamp(l1 - l0, min=1e-30), 0.0, 1.0)
    return q0 + t * (q1 - q0)


def table_y_at(log_y: torch.Tensor, q: torch.Tensor, c: torch.Tensor):
    """Inverse of the table: y with Q(alpha, y) = c. ``q`` is non-increasing,
    so the count of entries below ``c`` indexes the reversed table."""
    s = q.shape[0]
    cnt = torch.sum((q < c[..., None]).to(torch.int64), dim=-1)
    idx = torch.clamp(cnt, 1, s - 1)
    j0 = s - idx        # reversed idx - 1
    j1 = s - 1 - idx    # reversed idx
    q0, q1 = q[j0], q[j1]
    l0, l1 = log_y[j0], log_y[j1]
    t = torch.clamp((c - q0) / torch.clamp(q1 - q0, min=1e-30), 0.0, 1.0)
    return torch.exp(l0 + t * (l1 - l0))


def truncated_invgamma_sample_table(u, beta, lo, hi, log_y, q):
    """Truncated InverseGamma(alpha, scale=beta) inverse-CDF draw on
    ``[lo, hi]`` through the table (``ops/invgamma.py:150-159``)."""
    p_lo = table_q_at(log_y, q, beta / lo)
    p_hi = table_q_at(log_y, q, beta / hi)
    c = p_lo + u * (p_hi - p_lo)
    y = table_y_at(log_y, q, c)
    x = beta / torch.clamp(y, min=torch.finfo(beta.dtype).tiny)
    return torch.minimum(torch.maximum(x, lo), hi)


def sample_bandpowers_from_beta(beta, prior, log_y, q, *, gam=None, u=None,
                                seed=None, sids=None, g: int = 0,
                                alpha=None):
    """The bandpower conditional draw from ``beta`` (B, n) (port of
    ``ops/invgamma.py:201-264``), for any number of bounded bins and any
    integer ``alpha = Ntimes - 1``, in plain torch on ``beta``'s device.

    Free bins get ``beta / Gamma(alpha)``; the bounded bins ``prior.idx``
    (bounds ``prior.lo``, ``prior.hi``) the truncated inverse gamma through
    the table ``log_y``/``q`` at alpha + 1 = Ntimes, lane j of the
    uniforms for bounded bin j. Randomness: external ``gam`` (B, n) and
    ``u`` (B, >= npb), or the Philox streams of ``seed`` and the chain ids
    ``sids`` at global iteration ``g``: ``Gamma = -sum log u`` over the
    GAMMA words, exact for integer alpha at any size (the JAX package
    switches to ``jax.random.gamma`` above alpha = 512, the same
    distribution), and the UNIFORM words. This is the plain version of
    the ``bandpower`` kernel (``ops/kernels/rng_bandpower.py``)."""
    npb = prior.idx.shape[0]
    if gam is None:
        gam = philox.gamma_draws(seed, sids, g, beta.shape[1], int(alpha))
        u = philox.prior_uniforms(seed, sids, g, npb)
    free = beta / gam
    if npb == 0:
        return free
    idx = prior.idx.long()
    x = truncated_invgamma_sample_table(
        u[:, :npb], beta[:, idx], prior.lo, prior.hi, log_y, q)
    out = free.clone()
    out[:, idx] = x
    return out
