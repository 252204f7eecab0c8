"""Driver of the K-iteration chain (port of
``hydra_pspec_tpu/models/megachain.py:28-56, 200-407, 478-565``).

Randomness comes in two forms:

* ``seed`` and ``sids`` (production): per-chain Philox streams keyed on
  (seed, global chain id, global iteration), drawn by the kernels on CUDA
  and by the plain-torch twin on the CPU. A chain's samples depend on
  those three values only;
* ``randomness`` (pinning tests): explicit per-iteration arrays, in the
  JAX package's dict layout (``oa_re``, ``oa_im``, ``ob_re``, ``ob_im``,
  ``gam``, ``u_pb``), each with a leading K axis.

Not ported (they raise): the grouped time-flags mode (``group_times``,
``sidc``), the TPU scheduling knobs ``prefetch_rng`` and ``batch_tile``,
bf16 pass counts other than 3, a mesh, and the raw position-seeded seed
mode of the JAX package.
"""
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.kernels.impl import KERNELS, Impl
from ..ops.kernels.megachain import gcr_megachain
from ..ops.kernels.rng_bandpower import MAX_PRIOR_BINS, prior_bins
from .mega import MegaDims, MegaOperators

TFLAGS_ITEM = ("time-dependent flags (grouped megachain mode) are not "
               "ported yet (ROADMAP.md, Queue 1 item 8)")


class MegaChainTables(NamedTuple):
    """The InvGammaTable rows as float32 device tensors. (The JAX package
    tiles them to 8 sublanes; a CUDA kernel needs one row.)"""

    tlog: torch.Tensor  # (S,) log y
    q: torch.Tensor     # (S,) Q(alpha, y)


class ChainSample(NamedTuple):
    """Samples stacked over iterations, trimmed to the true dims and in the
    reference layout. Lean runs carry None for the per-time fields and a
    scalar chi^2 mean per iteration."""

    signal_cr: Optional[torch.Tensor]   # (K, B, Ntimes, Nfreqs) complex
    ps: torch.Tensor                    # (K, B, Nfreqs)
    fg_amps: Optional[torch.Tensor]     # (K, B, Ntimes, Nmodes) complex
    chisq: torch.Tensor                 # (K, B, Ntimes, Nfreqs) or (K, B)
    ln_post: torch.Tensor               # (K, B)


def make_chain_tables(mops: MegaOperators, device) -> MegaChainTables:
    return MegaChainTables(
        tlog=torch.from_numpy(np.array(mops.igt.log_y, np.float32)).to(
            device),
        q=torch.from_numpy(np.array(mops.igt.q, np.float32)).to(device))


def prior_static_from(prior, dims: MegaDims):
    """Host (2, Nfreqs-or-n) prior -> ``((idx, lo, hi), ...)`` for the
    bounded bins, with ``lo = prior[1]`` and ``hi = prior[0]``."""
    p = np.asarray(prior)
    idxs = np.nonzero(np.any(p > 0, axis=0))[0]
    if len(idxs) > MAX_PRIOR_BINS:
        raise NotImplementedError(
            f"megachain supports <= {MAX_PRIOR_BINS} bounded prior bins; "
            f"got {len(idxs)}; the single-step engine that takes more is "
            f"not ported yet (ROADMAP.md, Queue 1 item 9)")
    return tuple((int(i), float(p[1, i]), float(p[0, i])) for i in idxs)


def ln_post(noise_nu, bmask, ps):
    """(K, B) log posterior from the per-iteration vectors."""
    tiny = torch.finfo(torch.float32).tiny
    sig_term = torch.sum(bmask / torch.clamp(ps, min=tiny), dim=-1)
    return -(torch.sum(noise_nu, dim=-1) + sig_term)


def _randomness_on(randomness: dict, device) -> dict:
    """JAX-layout external randomness -> complex64 device tensors."""
    def t(x):
        if torch.is_tensor(x):
            return x.to(device=device, dtype=torch.float32)
        return torch.from_numpy(np.array(x, np.float32)).to(device)
    return dict(oa=torch.complex(t(randomness["oa_re"]),
                                 t(randomness["oa_im"])),
                ob=torch.complex(t(randomness["ob_re"]),
                                 t(randomness["ob_im"])),
                gam=t(randomness["gam"]), u_pb=t(randomness["u_pb"]))


def run_chunk_megachain(
    mops: MegaOperators,
    tables: MegaChainTables,
    dims: MegaDims,
    ps_pad: torch.Tensor,
    k_total: int,
    prior_static=(),
    *,
    seed: Optional[int] = None,
    sids=None,
    iter0: int = 0,
    randomness: Optional[dict] = None,
    refine: int = 1,
    store_cr: bool = True,
    chi_mask=None,
    inv_passes: int = 3,
    apply_passes: int = 3,
    warm_ns: int = 0,
    drift_max: float = 0.25,
    prefetch_rng: bool = False,
    group_times=(),
    impl: Impl = KERNELS,
):
    """One chunk of ``k_total`` iterations on ``ps_pad``'s device.

    ``chi_mask`` (optional (nfreqs,) 0/1, lean mode only): the scalar
    chi^2 is averaged over the masked channels. ``warm_ns > 0``: carry the
    system inverse across the chunk's iterations with that many
    Newton-Schulz steps while the chain's relative bandpower move stays
    under ``drift_max``. ``impl``: the kernels (default) or the plain torch
    versions (``ops.kernels.impl.PLAIN``). Returns ``(ps_pad_final,
    ChainSample)``."""
    if group_times:
        raise NotImplementedError(TFLAGS_ITEM)
    if prefetch_rng:
        raise NotImplementedError(
            "prefetch_rng is a TPU scheduling mode; it has no port")
    if inv_passes != 3 or apply_passes != 3:
        raise NotImplementedError(
            "inv_passes/apply_passes count bf16 passes of the TPU matmul; "
            "the port computes in full float32 (only the default 3 is "
            "accepted)")
    device = ps_pad.device
    if randomness is not None:
        rnd = _randomness_on(randomness, device)
        seed = sids = None
    else:
        rnd = None
        if seed is None or sids is None:
            raise ValueError(
                "give seed and sids (the raw position-seeded mode of the JAX "
                "package is not composition-invariant and is not ported)")
        sids = (sids.to(device=device, dtype=torch.int32)
                if torch.is_tensor(sids)
                else torch.as_tensor(np.asarray(sids, np.int32)).to(device))
    lean = not store_cr
    outs = gcr_megachain(
        mops, tables.tlog, tables.q, ps_pad, k_total,
        nfreqs_true=dims.nfreqs, ntimes_true=dims.ntimes,
        alpha_int=dims.ntimes - 1, all_unflagged=dims.all_unflagged,
        prior=prior_bins(prior_static, device), refine=refine,
        warm_ns=warm_ns, drift_max=drift_max, lean=lean, randomness=rnd,
        seed=seed, sids=sids, iter0=iter0, impl=impl)

    nf, nt, nm = dims.nfreqs, dims.ntimes, dims.nmodes
    lnp = ln_post(outs.noise_nu, outs.bmask, outs.ps)
    if store_cr:
        sample = ChainSample(
            signal_cr=outs.sig[:, :, :nf, :nt].transpose(2, 3),
            ps=outs.ps[:, :, :nf],
            fg_amps=outs.amp[:, :, :nm, :nt].transpose(2, 3),
            chisq=outs.chi[:, :, :nf, :nt].transpose(2, 3),
            ln_post=lnp)
    else:
        if chi_mask is not None:
            cm = torch.as_tensor(np.asarray(chi_mask, np.float32)).to(device)
            chi_mean = torch.sum(outs.chit[:, :, :nf] * cm, dim=2) / (
                torch.sum(cm) * nt)
        else:
            chi_mean = torch.sum(outs.chit[:, :, :nf], dim=2) / (nf * nt)
        sample = ChainSample(signal_cr=None, ps=outs.ps[:, :, :nf],
                             fg_amps=None, chisq=chi_mean, ln_post=lnp)
    return outs.ps_final, sample


def auto_chunk(niter: int, batch: int, dims: MegaDims,
               store_cr: bool) -> int:
    """Iterations per chunk (K) when the caller does not pin one.

    The JAX package sized K against a TPU's remote dispatch round trip.
    Here a chunk is a sequence of kernel launches, so K only bounds the
    device memory of one chunk's sample outputs (about 1 GiB) and the
    warm-start resets (one exact rebuild per chunk); the same quantized
    policy is kept so both packages chunk a run alike."""
    target = max(100, 6400 // max(batch, 1))
    if store_cr:
        n, t, m = dims.n, dims.t, dims.m
        bytes_per = 4 * (3 * n * t + 2 * m * t + 3 * n)
    else:
        bytes_per = 4 * 4 * dims.n
    cap = (1 << 30) // max(1, batch * bytes_per)
    k = min(target, max(100, cap), 1600, max(100, niter))
    return max(100, (k // 100) * 100)


def _cat(pieces):
    if len(pieces) == 1:
        return pieces[0]
    fields = {}
    for name in ChainSample._fields:
        xs = [getattr(p, name) for p in pieces]
        fields[name] = None if xs[0] is None else torch.cat(xs, 0)
    return ChainSample(**fields)


def run_chain_megachain(
    mops: MegaOperators,
    dims: MegaDims,
    ps0_pad: torch.Tensor,
    prior,
    niter: int,
    *,
    seed: Optional[int] = None,
    sids=None,
    iter0: int = 0,
    randomness=None,
    tables: Optional[MegaChainTables] = None,
    store_cr: bool = True,
    chi_mask=None,
    refine: int = 1,
    chunk: Optional[int] = None,
    warm_ns: int = 0,
    drift_max: float = 0.25,
):
    """A whole chain of ``niter`` iterations in chunks (default
    :func:`auto_chunk`), on ``ps0_pad``'s device. The streams continue at
    global iteration ``iter0``. ``randomness``: optional callable
    ``(iteration, k_total) -> dict`` of external randomness per chunk.
    Returns ``(ps_pad_final, ChainSample over niter)``."""
    if tables is None:
        tables = make_chain_tables(mops, ps0_pad.device)
    prior_static = prior_static_from(prior, dims)
    if chunk is None:
        chunk = auto_chunk(niter, ps0_pad.shape[0], dims, store_cr)
    chunk = min(niter, chunk)
    ps = ps0_pad
    pieces = []
    it = 0
    while it < niter:
        k_total = min(chunk, niter - it)
        ps, sample = run_chunk_megachain(
            mops, tables, dims, ps, k_total, prior_static,
            seed=seed, sids=sids, iter0=iter0 + it,
            randomness=(None if randomness is None
                        else randomness(iter0 + it, k_total)),
            refine=refine, store_cr=store_cr, chi_mask=chi_mask,
            warm_ns=warm_ns, drift_max=drift_max)
        pieces.append(sample)
        it += k_total
    return ps, _cat(pieces)
