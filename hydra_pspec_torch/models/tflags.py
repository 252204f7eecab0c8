"""Time-dependent flags: times grouped by flag pattern, one set of chain
operators per group (port of ``hydra_pspec_tpu/models/tflags.py:36-51,
168-184``; numpy only, so the groups equal the JAX package's exactly).

The reference collapses time-dependent flags to "any time flagged" per
channel (``run-hydra-pspec.py:541``, a FIXME), so one short RFI burst
removes a channel for the whole night. Here the times that share a flag
row form a group with its own per-channel weights; within a group the GCR
operator is constant, and the bandpower draw pools the delay statistics of
all groups (``models/megachain.py``, grouped mode).

The real engine's grouped step (``gibbs_step_tflags_real``, ``:187-332``)
runs a signature with more than 8 patterns; the megachain engine's grouped
mode (``models/megachain.py``) runs the others. The complex float64
engine's grouped step (``gibbs_step_tflags``, ``:68-166``) runs one
baseline's chains at a time, on that baseline's per-group operators
(``models/gcr.py``).
"""
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.invgamma import sample_bandpowers_grid
from ..ops.fourier import cfft
from ..ops.kernels import rng_bandpower as _rb
from ..ops.kernels.impl import KERNELS, Impl
from . import gcr, gibbs, rgibbs


class TimeGroup(NamedTuple):
    ops: gcr.ChainOperators
    idx: torch.Tensor  # int64 time indices of this group, increasing


class TimeGroupReal(NamedTuple):
    ops: rgibbs.RChainOperators
    idx: np.ndarray  # time indices of this group, increasing


def group_flag_patterns(flags_tf: np.ndarray):
    """Group times by identical flag row. ``flags_tf``: (Ntimes, Nfreqs)
    bool, True = flagged. Returns ``[(w_g, idx_g), ...]`` in order of first
    appearance, ``w_g`` the per-channel weights (1 = keep) and ``idx_g``
    the group's time indices (not necessarily contiguous)."""
    flags_tf = np.asarray(flags_tf, dtype=bool)
    _, first, inverse = np.unique(flags_tf, axis=0, return_index=True,
                                  return_inverse=True)
    inverse = inverse.reshape(-1)
    groups = []
    for uidx in np.argsort(first):
        idx = np.nonzero(inverse == uidx)[0]
        groups.append(((~flags_tf[idx[0]]).astype(float), idx))
    return groups


def build_grouped_operators(vis, flags_tf, fgmodes, ninv,
                            dtype=torch.complex128, device="cpu"):
    """Per-group chain constants of one baseline for the complex engine
    (``tflags.py:55-65``), on ``device``."""
    vis = np.asarray(vis)
    return [TimeGroup(ops=gcr.build_chain_operators(
                vis[idx], w_g, fgmodes, ninv, dtype=dtype, device=device),
                      idx=torch.as_tensor(idx, device=device))
            for w_g, idx in group_flag_patterns(flags_tf)]


def gibbs_step_tflags(groups, ps, prior, rand: dict, *,
                      map_estimate: bool = False, jitter: float = 0.0,
                      prior_idx=None):
    """One grouped Gibbs alternation of the complex engine
    (``tflags.py:68-143``): each time group draws with its own operators
    and the chains' ``ps`` (..., Nfreqs); the bandpower draw pools ``beta``
    over all times, alpha + 1 = the total time count. ``rand``: as
    :func:`gibbs.gibbs_step`, the omegas over all times in time order
    (group g takes those of its time indices). Returns ``(ps_new,
    gibbs.GibbsSample with every time in order, info)``."""
    ntimes = sum(int(g.idx.shape[0]) for g in groups)
    first = groups[0].ops
    nfreqs, nmodes = first.fgmodes.shape[-2:]
    npb = nfreqs if prior_idx is None else len(prior_idx)
    oa, ob, gam, u = gibbs.step_randomness(rand, ntimes, nfreqs, npb)
    batch = ps.shape[:-1]
    dev, dt = ps.device, first.d_w.dtype
    rdt = ps.dtype
    signal_cr = torch.zeros(batch + (ntimes, nfreqs), dtype=dt, device=dev)
    fg_amps = torch.zeros(batch + (ntimes, nmodes), dtype=dt, device=dev)
    chisq = torch.zeros(batch + (ntimes, nfreqs), dtype=rdt, device=dev)
    beta = torch.zeros(batch + (nfreqs,), dtype=rdt, device=dev)
    beta_masked = torch.zeros_like(beta)
    noise = torch.zeros(batch, dtype=rdt, device=dev)
    info = torch.zeros((), dtype=torch.int32, device=dev)
    for grp in groups:
        ops, idx = grp.ops, grp.idx
        pick = lambda z: None if z is None or map_estimate else z[..., idx, :]
        res = gcr.gcr_solve(ops, ps, pick(oa), pick(ob), jitter=jitter)
        resid = ops.d_w - (res.signal_cr + res.fg_amps @ ops.fgmodes.mT)
        sk = cfft(res.signal_cr, dim=-1)
        skm = cfft(res.signal_cr * ops.w[..., None, :], dim=-1)
        signal_cr[..., idx, :] = res.signal_cr
        fg_amps[..., idx, :] = res.fg_amps
        chisq[..., idx, :] = (gibbs._abs2(resid)
                              * ops.noise.ninv_full_diag[..., None, :])
        beta = beta + gibbs._abs2(sk).sum(dim=-2)
        noise = noise + torch.sum(
            (ops.noise.apply_ni(resid).conj() * resid).real, dim=(-2, -1))
        beta_masked = beta_masked + gibbs._abs2(skm).sum(dim=-2)
        info = torch.maximum(info, res.info.max())
    ps_new = sample_bandpowers_grid(beta, ntimes, prior, gam=gam, u=u,
                                    prior_idx=prior_idx)
    tiny = torch.finfo(rdt).tiny
    sig_term = torch.sum(beta_masked / torch.clamp(ps_new, min=tiny),
                         dim=-1)
    sample = gibbs.GibbsSample(signal_cr, ps_new, fg_amps, chisq,
                               -(noise + sig_term))
    return ps_new, sample, info


def run_chain_tflags(groups, ps0, prior, niter: int, *, seed=None,
                     sids=None, iter0: int = 0,
                     randomness: Optional[dict] = None,
                     map_estimate: bool = False, jitter: float = 0.0,
                     store_cr: bool = True):
    """``niter`` grouped steps of the chains ``ps0`` (B, Nfreqs) of one
    baseline (``tflags.py:146-166``), eagerly; arguments and result as
    :func:`gibbs.run_chain`."""
    prior_t, prior_idx = gibbs.prior_on_device(prior, ps0.device)
    ps = ps0
    parts = {name: [] for name in rgibbs.ChainSample._fields}
    info = torch.zeros((), dtype=torch.int32, device=ps0.device)
    for k in range(niter):
        rand = ({name: v[k] for name, v in randomness.items()}
                if randomness is not None
                else dict(seed=seed, sids=sids, g=iter0 + k))
        ps, s, inf = gibbs_step_tflags(groups, ps, prior_t, rand,
                                       map_estimate=map_estimate,
                                       jitter=jitter, prior_idx=prior_idx)
        info = torch.maximum(info, inf)
        gibbs.append_step(parts, s, store_cr)
    gibbs.check_factors(info, iter0, niter)
    return ps, rgibbs.stack_samples(parts)


def build_grouped_operators_real(vis, flags_tf, fgmodes, ninv,
                                 dtype=np.float32):
    """Per-group batch-of-one chain operators of one baseline."""
    vis = np.asarray(vis)
    return [TimeGroupReal(ops=rgibbs.build_chain_operators(
                vis[idx], w_g, fgmodes, ninv, dtype=dtype), idx=idx)
            for w_g, idx in group_flag_patterns(flags_tf)]


def to_device(groups, device):
    """Host groups (``ops`` stacked over the signature's chains) ->
    groups of :class:`rgibbs.RealOperators` with ``idx`` as an int64
    tensor, on ``device``."""
    return [TimeGroupReal(ops=rgibbs.to_device(g.ops, device),
                          idx=torch.as_tensor(np.asarray(g.idx),
                                              dtype=torch.int64,
                                              device=device))
            for g in groups]


def gibbs_step_tflags_real(groups, ps, prior, tlog_total, q_total,
                           rand: dict, *, map_estimate: bool = False,
                           jitter: float = 0.0, solver: str = "auto",
                           impl: Impl = KERNELS, segments=None):
    """One grouped Gibbs alternation of the real engine
    (``tflags.py:187-305``): every time group solves its own GCR system
    with the chain's ``ps`` (B, Nfreqs), and the bandpower draw pools
    ``beta`` over the groups, through the table ``tlog_total``/``q_total``
    at alpha + 1 = the TOTAL time count (each group's own table carries the
    group's alpha). ``rand``: as :func:`rgibbs.gibbs_step`, with external
    omegas over all times in time order; group g takes those of its global
    time indices, and on the streams draws them there at its own width,
    all groups in one launch (``segments``: :func:`time_segments` of
    ``groups``, made here if not given). As in the JAX package, the
    ln-posterior noise term uses the diagonal of ``Ni``."""
    batch, nfreqs = ps.shape
    ntimes_total = sum(int(g.idx.shape[0]) for g in groups)
    omegas = [(None, None)] * len(groups)
    if not map_estimate:
        if segments is None:
            segments = time_segments(groups)
        omegas = rgibbs.omegas_t(rand, ntimes_total, nfreqs, impl, segments)
    dev = ps.device
    f32 = dict(dtype=torch.float32, device=dev)
    c64 = dict(dtype=torch.complex64, device=dev)
    nmodes = groups[0].ops.fg.shape[-1]
    sig_t = torch.zeros((batch, nfreqs, ntimes_total), **c64)
    fga_t = torch.zeros((batch, nmodes, ntimes_total), **c64)
    chi_t = torch.zeros((batch, nfreqs, ntimes_total), **f32)
    beta = torch.zeros((batch, nfreqs), **f32)
    beta_masked = torch.zeros((batch, nfreqs), **f32)
    noise = torch.zeros((batch,), **f32)
    chi_sum = torch.zeros((batch,), **f32)
    for grp, (oa_g, ob_g) in zip(groups, omegas):
        d = rgibbs.draw(grp.ops, ps, oa_g, ob_g, jitter, solver, impl)
        r = rgibbs.residual(grp.ops, d, dense_noise=False,
                            all_unflagged=False, impl=impl)
        sig_t[:, :, grp.idx] = d.sig_t
        fga_t[:, :, grp.idx] = d.fga_t
        chi_t[:, :, grp.idx] = r.chi_t
        beta = beta + d.beta
        noise = noise + r.noise
        beta_masked = beta_masked + r.beta_masked
        chi_sum = chi_sum + r.chi_sum
    ps_new = impl.bandpower(beta, prior, tlog_total, q_total,
                            **rgibbs.bandpower_args(rand, ntimes_total - 1))
    ln_post = -(noise + rgibbs.sig_term(beta_masked, ps_new))
    t = rgibbs._t
    return ps_new, rgibbs.RealSample(t(sig_t), ps_new, t(fga_t), t(chi_t),
                                     ln_post,
                                     chi_sum / (ntimes_total * nfreqs))


def time_segments(groups):
    """The time groups of device ``groups`` (:func:`to_device`) as the
    segments of one omega launch (``rng_bandpower.time_segments``)."""
    return _rb.time_segments([g.idx for g in groups])


def run_chain_tflags_real(groups, ps0, prior, niter: int, tlog_total,
                          q_total, *, seed=None, sids=None, iter0: int = 0,
                          randomness: Optional[dict] = None,
                          map_estimate: bool = False, jitter: float = 0.0,
                          store_cr: bool = True, solver: str = "auto",
                          impl: Impl = KERNELS):
    """``niter`` grouped steps (``tflags.py:308-332``); arguments and
    result as :func:`rgibbs.run_chain`."""
    ps = ps0
    parts = {name: [] for name in rgibbs.ChainSample._fields}
    segments = time_segments(groups)
    for k in range(niter):
        rand = rgibbs.iteration_randomness(randomness, k, seed, sids,
                                           iter0 + k)
        ps, s = gibbs_step_tflags_real(
            groups, ps, prior, tlog_total, q_total, rand,
            map_estimate=map_estimate, jitter=jitter, solver=solver,
            impl=impl, segments=segments)
        rgibbs.append_sample(parts, s, store_cr)
    return ps, rgibbs.stack_samples(parts)
