"""The complex float64 engine: the Gibbs step, the chain and the
reference-API mirrors (port of ``hydra_pspec_tpu/models/gibbs.py:23-305``),
in complex128 on any device.

One step (reference pspec.py:377-490): the constrained-realization draw of
the signal and the foreground amplitudes (``models/gcr.py``), the
bandpower draw from the delay transform of the signal with the grid
inversion for bounded bins (``ops/invgamma.py``), then chi^2 and the
log-posterior. The JAX engine is plain XLA, a ``lax.scan`` vmapped over
(baseline x chain); here every step runs batched over the leading axis of
the chain operators, and on the card :func:`run_chain` runs a chunk of
steps as one CUDA graph (``ops/kernels/graph.py::ChunkGraph``): the step
reads nothing back to the host, its random words come from the Philox
streams of the iteration held on the device, and the factor's status is
read once per chunk.

Randomness of a step: external arrays (``oa``, ``ob`` standard complex
normals (..., Ntimes, Nfreqs), ``gam`` the Gamma(Ntimes - 1) draws (...,
Nfreqs), ``u`` the uniforms of the bounded bins), for pins against the JAX
package's key schedule; or the float64 Philox streams of ``seed``, the
chain ids ``sids`` and the global iteration ``g`` (``ops/philox.py``), so
that a chain's draws depend on (seed, sid, iteration) only.
"""
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import philox
from ..ops.fourier import cfft, covariance_from_pspec, pspec_from_covariance
from ..ops.invgamma import sample_bandpowers
from ..ops.kernels.graph import replay_chunk
from .gcr import (ChainOperators, build_chain_operators, gcr_solve,
                  map_chains, stack_chain_operators)
from .rgibbs import ChainSample, stack_samples


CHAIN_BLOCK = 16   # chains a step runs together on the card (run_chain)


class GibbsSample(NamedTuple):
    """One step's outputs (reference pspec.py:590-596), with the batch
    axes of the operators."""

    signal_cr: torch.Tensor   # (..., Ntimes, Nfreqs) complex
    ps: torch.Tensor          # (..., Nfreqs) bandpowers, centred order
    fg_amps: torch.Tensor     # (..., Ntimes, Nmodes) complex
    chisq: torch.Tensor       # (..., Ntimes, Nfreqs)
    ln_post: torch.Tensor     # (...)


def initial_ps(S_initial, fourier_op) -> torch.Tensor:
    """The bandpower state of an initial covariance (``gibbs.py:34-48``):
    ``diag(F S F^H) / n^2``, rescaled by ``n^2`` to the sampler's
    ``S = F^H diag(ps / n^2) F`` convention, clipped at 0."""
    S = torch.as_tensor(np.asarray(S_initial)).to(fourier_op.device)
    n = S.shape[-1]
    return torch.clamp(pspec_from_covariance(S, fourier_op) * n**2, min=0.0)


def step_randomness(rand: dict, ntimes: int, nfreqs: int, npb: int):
    """``(oa, ob, gam, u)`` of one step: the external arrays of ``rand``,
    or the Philox words of ``rand["seed"]``, ``rand["sids"]`` and
    iteration ``rand["g"]`` (an int or a 0-dim device tensor)."""
    if "gam" in rand:
        return rand.get("oa"), rand.get("ob"), rand["gam"], rand["u"]
    return philox.draws64(rand["seed"], rand["sids"], rand["g"], ntimes,
                          nfreqs, ntimes - 1, max(npb, 1))


def _abs2(z):
    return z.real * z.real + z.imag * z.imag


def gibbs_step(ops: ChainOperators, ps, prior, rand: dict, *,
               map_estimate: bool = False, jitter: float = 0.0,
               prior_idx=None):
    """One Gibbs alternation (``gibbs.py:51-124``). ``prior`` (2, Nfreqs)
    upper and lower bounds (a bin is bounded where either is positive);
    ``prior_idx``: the bins that may carry a prior (then the uniforms have
    one lane per listed bin, else one per bin); ``rand``: module
    docstring. Returns ``(ps_new, GibbsSample, info)``, ``info`` the
    factor's status (0 = factored)."""
    ntimes, nfreqs = ops.d_w.shape[-2:]
    npb = nfreqs if prior_idx is None else len(prior_idx)
    oa, ob, gam, u = step_randomness(rand, ntimes, nfreqs, npb)
    if map_estimate:
        oa = ob = None
    cr = gcr_solve(ops, ps, oa, ob, jitter=jitter)
    model = cr.signal_cr + cr.fg_amps @ ops.fgmodes.mT
    resid = ops.d_w - model
    chisq = _abs2(resid) * ops.noise.ninv_full_diag[..., None, :]

    sk = cfft(cr.signal_cr, dim=-1)
    ps_new = sample_bandpowers(sk, prior, gam=gam, u=u, prior_idx=prior_idx)

    # log posterior under the new bandpowers (pspec.py:472-485), the S^-1
    # form analytic: x^H S^-1 x = sum_k |cfft(w x)_k|^2 / ps_k
    noise_term = torch.sum((ops.noise.apply_ni(resid).conj() * resid).real,
                           dim=(-2, -1))
    sk_masked = cfft(cr.signal_cr * ops.w[..., None, :], dim=-1)
    tiny = torch.finfo(ps_new.dtype).tiny
    sig_term = torch.sum(_abs2(sk_masked)
                         / torch.clamp(ps_new, min=tiny)[..., None, :],
                         dim=(-2, -1))
    sample = GibbsSample(cr.signal_cr, ps_new, cr.fg_amps, chisq,
                         -(noise_term + sig_term))
    return ps_new, sample, cr.info


def gibbs_step_fgmodes(vis, flags, signal_S, fgmodes, Ninv, ps_prior=None,
                       map_estimate=False, jitter=0.0, *, rand: dict,
                       device="cuda"):
    """The reference API ``gibbs_step_fgmodes`` (``gibbs.py:127-148``) on
    a dense covariance, on ``device`` (the card unless the caller asks for
    the CPU): returns ``(signal_cr, S_sample, ps_sample,
    fg_amps, chisq, ln_post)``. Rebuilds the chain's constants each call;
    ``rand`` as :func:`gibbs_step`."""
    ops = build_chain_operators(vis, flags, fgmodes, Ninv, device=device)
    if ps_prior is None:
        ps_prior = np.zeros((2, ops.d_w.shape[-1]))
    prior = torch.as_tensor(np.asarray(ps_prior), dtype=torch.float64,
                            device=device)
    ps = initial_ps(signal_S, ops.fourier_op)
    ps_new, s, _ = gibbs_step(ops, ps, prior, rand,
                              map_estimate=map_estimate, jitter=jitter)
    n = ops.d_w.shape[-1]
    S_sample = covariance_from_pspec(ps_new / n**2, ops.fourier_op)
    return s.signal_cr, S_sample, s.ps, s.fg_amps, s.chisq, s.ln_post


def prior_on_device(prior, device):
    """``(prior, prior_idx)`` on ``device``: the host (2, Nfreqs) bounds as
    float64 and the int64 indices of the bins with a bound (made before a
    graph's capture, which may copy nothing from the host)."""
    prior = np.asarray(prior, dtype=np.float64)
    idx = np.nonzero(np.any(prior > 0, axis=0))[0]
    return (torch.as_tensor(prior, device=device),
            torch.as_tensor(idx, dtype=torch.int64, device=device))


def chunk_body(ops: ChainOperators, prior, prior_idx, *, seed=None,
               sids=None, randomness: Optional[dict] = None,
               map_estimate: bool = False, jitter: float = 0.0,
               store_cr: bool = True, block: Optional[int] = None):
    """``body(ps, g0, k_total)``: ``k_total`` steps from ``ps`` at global
    iteration ``g0`` (an int, or a (1,) device counter in a graph), as
    :class:`ops.kernels.graph.ChunkGraph` calls it, each step on blocks of
    ``block`` chains (rows ``j*block`` to ``(j+1)*block - 1``; the batch a
    multiple of it) or on the whole batch. Returns ``(ps_final,
    ChainSample over the chunk, info)``, ``info`` the largest factor status
    of any step and chain."""
    shared = ops.d_w.ndim == 2      # one baseline's operators, all chains

    def body(ps, g0, k_total):
        size = ps.shape[0] if block is None else block
        rows = [slice(j, j + size) for j in range(0, ps.shape[0], size)]
        parts = {name: [] for name in ChainSample._fields}
        info = torch.zeros((), dtype=torch.int32, device=ps.device)
        for k in range(k_total):
            g = philox.iteration(g0, k)
            steps = []
            for r in rows:
                if randomness is not None:
                    rand = {name: v[k][r] for name, v in randomness.items()}
                else:
                    rand = dict(seed=seed, sids=sids[r], g=g)
                steps.append(gibbs_step(
                    ops if shared else map_chains(ops, lambda x: x[r]),
                    ps[r], prior, rand, map_estimate=map_estimate,
                    jitter=jitter, prior_idx=prior_idx))
            if len(steps) == 1:
                ps, s, inf = steps[0]
            else:
                ps = torch.cat([st[0] for st in steps])
                s = GibbsSample(*(torch.cat(f) for f in zip(
                    *(st[1] for st in steps))))
                inf = torch.stack([st[2].max() for st in steps])
            info = torch.maximum(info, inf.max())
            append_step(parts, s, store_cr)
        return ps, stack_samples(parts), info

    return body


def append_step(parts: dict, s: GibbsSample, store_cr: bool):
    """Add one step's sample to the per-field lists of a chunk; a lean
    chunk keeps the chi^2 mean of each chain."""
    parts["ps"].append(s.ps)
    parts["ln_post"].append(s.ln_post)
    if store_cr:
        parts["signal_cr"].append(s.signal_cr)
        parts["fg_amps"].append(s.fg_amps)
        parts["chisq"].append(s.chisq)
    else:
        parts["chisq"].append(s.chisq.mean(dim=(-2, -1)))


def check_factors(info: torch.Tensor, iter0: int, niter: int):
    """Raise if a chunk's largest ``cholesky_ex`` status is not 0 (one
    read of the device a chunk)."""
    if int(info) != 0:
        raise FloatingPointError(
            f"a Cholesky factor failed in iterations {iter0}.."
            f"{iter0 + niter - 1} (cholesky_ex info {int(info)})")


def run_chain(ops: ChainOperators, ps0, prior, niter: int, *, seed=None,
              sids=None, iter0: int = 0, randomness: Optional[dict] = None,
              map_estimate: bool = False, jitter: float = 0.0,
              store_cr: bool = True, graph: bool = True,
              graphs: Optional[dict] = None):
    """``niter`` steps of the batched chains ``ps0`` (B, Nfreqs) as one
    chunk (``gibbs.py:151-185``), from global iteration ``iter0``:
    ``randomness`` (the chunk's external arrays, each with a leading K
    axis) or the Philox streams of ``seed`` and the int32 chain ids
    ``sids``. On the card with the streams and ``graph``, the chunk is a
    :class:`ChunkGraph` of ``graphs`` (captured at its first use, then
    replayed: the sample holds views of its outputs until its next
    replay). Reads the factors' status once and raises if any failed.

    On the card each step runs on blocks of :data:`CHAIN_BLOCK` chains,
    the batch padded with copies of its last chain to a multiple of it.
    The card's batched products, factorizations, FFTs and reductions pick
    their kernels by the batch's size, so a chain's last bits would
    depend on how many chains run beside it; in blocks of a fixed size
    they do not, and a subset of baselines reproduces the full run's
    files (the float32 engines get this from their hand-written kernels).
    The CPU's results do not depend on the batch: it runs the whole
    batch at once.

    Returns ``(ps_final, rgibbs.ChainSample)``, iterations on axis 0; lean
    runs (``store_cr=False``) carry the chi^2 mean per chain."""
    dev = ps0.device
    B = ps0.shape[0]
    block = CHAIN_BLOCK if dev.type == "cuda" else None
    pad = 0 if block is None else -B % block
    if pad:
        idx = torch.cat([torch.arange(B, device=dev),
                         torch.full((pad,), B - 1, device=dev)])
        if ops.d_w.ndim > 2:
            ops = map_chains(ops, lambda x: x.index_select(0, idx))
        ps0 = ps0.index_select(0, idx)
        sids = None if sids is None else sids.index_select(0, idx)
        if randomness is not None:
            randomness = {name: v.index_select(1, idx)
                          for name, v in randomness.items()}
    prior_t, prior_idx = prior_on_device(prior, dev)
    body = lambda: chunk_body(ops, prior_t, prior_idx, seed=seed, sids=sids,
                              randomness=randomness,
                              map_estimate=map_estimate, jitter=jitter,
                              store_cr=store_cr, block=block)
    if graph and randomness is None and dev.type == "cuda":
        key = ("complex", niter, store_cr, map_estimate, jitter)
        ps, sample, info = replay_chunk({} if graphs is None else graphs,
                                        key, body, ps0, niter, iter0)
    else:
        ps, sample, info = body()(ps0, iter0, niter)
    check_factors(info, iter0, niter)
    if pad:
        ps = ps[:B]
        sample = ChainSample(*(None if x is None else x[:, :B]
                               for x in sample))
    return ps, sample


def _stack_chunks(chunks, fourier_op, store_cr):
    """Host arrays of the chunks of one chain: ``(signal_cr, S_final,
    signal_ps, fg_amps, chisq, ln_post)`` (``gibbs.py:262-282``)."""
    cat = lambda name: np.concatenate([np.atleast_1d(getattr(c, name))
                                       for c in chunks])
    signal_ps, ln_post, chisq = cat("ps"), cat("ln_post"), cat("chisq")
    if store_cr:
        signal_cr, fg_amps = cat("signal_cr"), cat("fg_amps")
    else:
        signal_cr = fg_amps = np.zeros((0,))
    n = signal_ps.shape[-1]
    S_final = covariance_from_pspec(
        torch.as_tensor(signal_ps[-1] / n**2), fourier_op.cpu()).numpy()
    return signal_cr, S_final, signal_ps, fg_amps, chisq, ln_post


def gibbs_sample_with_fg(vis, flags, S_initial, fgmodes, Ninv, ps_prior,
                         Niter: int = 100, seed: Optional[int] = None,
                         verbose: bool = True, write_Niter: int = 100,
                         out_dir=None, map_estimate: bool = False,
                         store_cr: bool = True, jitter: float = 0.0,
                         device="cuda"):
    """The reference API ``gibbs_sample_with_fg`` (``gibbs.py:188-259``)
    for one baseline on ``device`` (the card by default): returns ``(signal_cr, signal_S,
    signal_ps, fg_amps, chisq, ln_post, write_time)`` as numpy arrays,
    ``signal_S`` the final covariance sample, and writes the samples
    every ``write_Niter`` iterations to ``out_dir``. The chain is stream 0
    of ``seed``."""
    from ..utils import io as hio

    if map_estimate:
        Niter = write_Niter = 1
    seed = 0 if seed is None else int(seed)
    ops = stack_chain_operators([build_chain_operators(
        vis, flags, fgmodes, Ninv, device=device)])
    ps = initial_ps(S_initial, ops.fourier_op)[None]
    sids = torch.zeros((1,), dtype=torch.int32, device=ps.device)
    chunks, write_time, done = [], 0.0, 0
    while done < Niter:
        n = min(write_Niter, Niter - done)
        ps, s = run_chain(ops, ps, ps_prior, n, seed=seed, sids=sids,
                          iter0=done, map_estimate=map_estimate,
                          jitter=jitter, store_cr=store_cr, graph=False)
        chunks.append(ChainSample(*(None if x is None else x[:, 0].cpu()
                                    .numpy() for x in s)))
        done += n
        if verbose:
            print(f"iter {done}/{Niter}  chisq={np.mean(chunks[-1].chisq):.4f}"
                  f"  ln_post={chunks[-1].ln_post[-1]:.1f}")
        if out_dir is not None:
            t0 = time.perf_counter()
            hio.write_numpy_files(out_dir, *_stack_chunks(
                chunks, ops.fourier_op, store_cr))
            write_time += time.perf_counter() - t0
    return _stack_chunks(chunks, ops.fourier_op, store_cr) + (write_time,)


def gcr_fgmodes(vis, flags, signal_S, fgmodes, Ninv, map_estimate=False, *,
                omega_a=None, omega_b=None, seed: int = 0,
                device="cuda"):
    """The reference API ``gcr_fgmodes`` (``gibbs.py:285-305``): signal and
    foreground-amplitude realizations for every time of one baseline,
    ``(Ntimes, Nfreqs + Nmodes)``, signal columns first, on ``device``
    (the card by default). The omegas are given, or drawn from stream 0 of ``seed`` at iteration 0."""
    ops = build_chain_operators(vis, flags, fgmodes, Ninv, device=device)
    ps = initial_ps(signal_S, ops.fourier_op)
    if map_estimate:
        omega_a = omega_b = None
    elif omega_a is None:
        ntimes, nfreqs = ops.d_w.shape
        sids = torch.zeros((1,), dtype=torch.int32, device=ps.device)
        omega_a, omega_b = (z[0] for z in philox.draws64(
            seed, sids, 0, ntimes, nfreqs, ntimes - 1, 1)[:2])
    res = gcr_solve(ops, ps, omega_a, omega_b)
    return torch.cat([res.signal_cr, res.fg_amps], dim=-1)
