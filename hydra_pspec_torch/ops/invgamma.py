"""Truncated inverse-gamma sampling: the table of the float32 engines and
the grid inversion of the complex float64 engine.

Port of ``hydra_pspec_tpu/ops/invgamma.py``. The table of the
regularized upper gamma ``Q(alpha, y)`` on a log-spaced ``y`` grid is built
once on the host in float64 with scipy and stored in float32, as the JAX
package does. The lookups below are plain torch and serve as the reference
semantics of the bandpower kernel (``ops/kernels/rng_bandpower.py``).
"""
from typing import NamedTuple

import numpy as np
import torch

from . import philox
from .fourier import cfft
from .special import (as_input, gammaincc_fixed, input_device,
                      iters_for_shape, on_device)


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


# --- the complex float64 engine's draw: the grid inversion ----------------
# (``ops/invgamma.py:32-80`` and ``:162-199``, ``:267-292``)

_NGRID = 1000  # the reference's interpolation grid


def invgamma_cdf(x, alpha, beta, iters=None):
    """CDF of InverseGamma(alpha, scale=beta): ``Q(alpha, beta / x)``, the
    fixed-count upper incomplete gamma (``ops/special.py``)."""
    return gammaincc_fixed(alpha, beta / x, iters=iters)


def truncated_invgamma_sample(u, alpha, beta, lo, hi, ngrid: int = _NGRID,
                              iters=None):
    """Inverse-CDF draw from InverseGamma(alpha, scale=beta) truncated to
    ``[lo, hi]`` given a uniform ``u`` (reference pspec.py:50-62): the CDF
    on a log grid of ``ngrid`` points over the bounds, renormalised over
    the truncation, linearly interpolated at ``u``. Flat stretches of the
    CDF are bridged with a clamped denominator, as the JAX function does.
    Arguments broadcast; the result has their shape and ``beta``'s
    floating dtype (at least float64 for Python scalars)."""
    dt = beta.dtype if torch.is_tensor(beta) else torch.float64
    dev = beta.device if torch.is_tensor(beta) else None
    u, alpha, beta, lo, hi = torch.broadcast_tensors(
        *(on_device(v, dev).to(dt) for v in (u, alpha, beta, lo, hi)))
    t = torch.linspace(0.0, 1.0, ngrid, dtype=dt, device=beta.device)
    log_lo = torch.log10(lo)[..., None]
    log_hi = torch.log10(hi)[..., None]
    x = 10.0 ** (log_lo + (log_hi - log_lo) * t)
    cdf = invgamma_cdf(x, alpha[..., None], beta[..., None], iters=iters)
    cdf = cdf - cdf[..., :1]
    tiny = torch.finfo(dt).tiny
    cdf = cdf / torch.clamp(cdf[..., -1:], min=tiny)
    idx = torch.clamp(torch.sum((cdf < u[..., None]).to(torch.int64),
                                dim=-1), 1, ngrid - 1)[..., None]
    c0 = torch.gather(cdf, -1, idx - 1)[..., 0]
    c1 = torch.gather(cdf, -1, idx)[..., 0]
    x0 = torch.gather(x, -1, idx - 1)[..., 0]
    x1 = torch.gather(x, -1, idx)[..., 0]
    frac = torch.clamp((u - c0) / torch.clamp(c1 - c0, min=tiny), 0.0, 1.0)
    return x0 + frac * (x1 - x0)


def inversion_sample_invgamma(alpha, beta, prior_min, prior_max, *, u,
                              ngrid: int = _NGRID, device="cuda"):
    """One truncated draw with the reference API's checks
    (pspec.py:40-47), at the given uniform ``u`` (the JAX function takes a
    PRNG key and draws ``u`` from it), on the device of the tensor inputs,
    or on ``device`` (the card unless the caller asks for the CPU) when
    none is a tensor."""
    if prior_min <= 0:
        raise ValueError("prior_min must be greater than zero")
    if prior_max <= 0:
        raise ValueError("prior_max must be greater than zero")
    if not np.isfinite(prior_max):
        raise ValueError("prior_max must be finite")
    if prior_max <= prior_min:
        raise ValueError("prior_max must be greater than prior_min")
    device = input_device(device, alpha, beta, prior_min, prior_max, u)
    if not torch.is_tensor(beta):   # the draw's device and float64
        beta = torch.as_tensor(beta, dtype=torch.float64, device=device)
    return truncated_invgamma_sample(u, alpha, beta, prior_min, prior_max,
                                     ngrid=ngrid)


def sample_bandpowers_grid(beta, ntimes: int, prior, *, gam, u,
                           prior_idx=None):
    """The bandpower conditional draw from ``beta_k = sum_t |sk|^2`` (...,
    n) with the grid inversion (``sample_bandpowers_from_beta`` of the JAX
    package without its table, as its complex engine runs it): free bins
    ``beta / gam``, ``gam`` the Gamma(Ntimes - 1) draws (..., n); bounded
    bins the truncated inverse gamma at alpha + 1 = Ntimes with the
    fixed counts of ``special.iters_for_shape(Ntimes + 1)``. Uniforms
    ``u``: (..., n), lane k for bin k, or with ``prior_idx`` (npb,)
    (..., npb), lane j for bin ``prior_idx[j]``, as in the JAX function."""
    alpha = float(ntimes) - 1.0
    iters = iters_for_shape(float(ntimes) + 1.0)
    prior = torch.as_tensor(prior).to(device=beta.device, dtype=beta.dtype)
    free = beta / gam
    if prior_idx is None:
        has = torch.any(prior > 0, dim=0)
        lo = torch.where(has, prior[1], torch.ones_like(prior[1]))
        hi = torch.where(has, prior[0], 10.0 * torch.ones_like(prior[0]))
        bounded = truncated_invgamma_sample(u, alpha + 1.0, beta, lo, hi,
                                            iters=iters)
        return torch.where(has, bounded, free)
    idx = torch.as_tensor(prior_idx).to(device=beta.device,
                                        dtype=torch.int64)
    p_sub = prior[:, idx]
    has = torch.any(p_sub > 0, dim=0)
    lo = torch.where(has, p_sub[1], torch.ones_like(p_sub[1]))
    hi = torch.where(has, p_sub[0], 10.0 * torch.ones_like(p_sub[0]))
    bounded = truncated_invgamma_sample(u[..., :idx.shape[0]], alpha + 1.0,
                                        beta[..., idx], lo, hi, iters=iters)
    out = free.clone()
    out[..., idx] = torch.where(has, bounded, free[..., idx])
    return out


def sample_bandpowers(sk, prior, *, gam, u, prior_idx=None):
    """The bandpower draw from the delay transform ``sk`` (..., Ntimes, n)
    of the signal (``ops/invgamma.py:162-183``); randomness as
    :func:`sample_bandpowers_grid`."""
    beta = torch.sum(sk.real * sk.real + sk.imag * sk.imag, dim=-2)
    return sample_bandpowers_grid(beta, sk.shape[-2], prior, gam=gam, u=u,
                                  prior_idx=prior_idx)


def sample_S(s=None, sk=None, prior=None, *, gam, u, device="cuda"):
    """Bandpower draw from real-space ``s`` or delay-space ``sk`` signal
    samples (Ntimes, n): the reference API (pspec.py:67-127), with the
    Gamma draws and uniforms given; on the device of the tensor inputs, or
    on ``device`` (the card unless the caller asks for the CPU) when none
    is a tensor."""
    if s is None and sk is None:
        raise ValueError("Must pass in s (real space) or sk (Fourier space).")
    device = input_device(device, s, sk, prior, gam, u)
    sk = (cfft(as_input(s, device), dim=-1) if sk is None
          else as_input(sk, device))
    if prior is None:
        prior = torch.zeros((2, sk.shape[-1]), dtype=sk.real.dtype,
                            device=device)
    return sample_bandpowers(sk, prior, gam=as_input(gam, device),
                             u=as_input(u, device))


def sprior(signals, bins: int, factor: float, *, device="cuda"):
    """A ``(2, Nfreqs)`` bandpower prior window from true signals
    (reference pspec.py:130-148): bounds ``ds * factor`` and
    ``ds / factor`` within ``bins`` of delay 0 (FFT order), zero elsewhere,
    normalised by ``Ntimes / 2 - 1``; on ``signals``' device when it is a
    tensor, else on ``device`` (the card unless the caller asks for the
    CPU)."""
    signals = as_input(signals, device)
    nobs, nfreq = signals.shape
    sk = torch.fft.fft(signals, dim=-1)
    ds = torch.sum(sk.real * sk.real + sk.imag * sk.imag, dim=0)
    prior = torch.stack([ds * factor, ds / factor])
    mask = torch.zeros(nfreq, dtype=torch.bool, device=signals.device)
    mask[:bins + 1] = True
    if bins > 0:
        mask[-bins:] = True
    return prior * mask[None, :] / (nobs / 2 - 1)
