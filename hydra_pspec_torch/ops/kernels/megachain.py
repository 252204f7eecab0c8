"""K whole Gibbs iterations per chain: the port of the TPU kernel
``ops/pallas/megachain.py::gcr_megachain`` in plain mode (:469-694).

On the TPU this is one Pallas program that keeps every chain's constants
in VMEM for K iterations. Here each iteration is a short sequence of the
hand-written kernels (:mod:`megastep`), with the bandpower state carried
on the device:

* the omegas from the per-chain Philox streams (:func:`rng_fields`), or
  external randomness;
* the drift-gated Newton-Schulz warm start of the system inverse
  (:349-397), decided per chain: NS refresh ``X <- X (2I - S X)`` unless
  this is the chunk's first iteration or the chain's relative bandpower
  move is not provably small (NaN-safe), in which case the exact inverse is
  selected. The gate and the select are torch glue; the products and the
  inverse are kernels;
* :func:`megastep.draw_body`;
* the bandpower conditional (:func:`sample_bandpowers`).

``lean`` returns only the time-reduced chi and the per-iteration vectors.
"""
from typing import NamedTuple, Optional

import torch

from .impl import KERNELS, Impl
from .megastep import draw_body
from .rng_bandpower import PriorBins


class ChainOut(NamedTuple):
    """Per-iteration outputs with a leading K axis (padded layout)."""

    sig: Optional[torch.Tensor]     # (K, B, n, t) complex; None when lean
    amp: Optional[torch.Tensor]     # (K, B, m, t) complex; None when lean
    chi: Optional[torch.Tensor]     # (K, B, n, t); None when lean
    chit: Optional[torch.Tensor]    # (K, B, n); lean only
    ps: torch.Tensor                # (K, B, n)
    noise_nu: torch.Tensor          # (K, B, n)
    bmask: torch.Tensor             # (K, B, n)
    ps_final: torch.Tensor          # (B, n)


def sample_bandpowers(beta, prior: PriorBins, tlog, q, impl=KERNELS,
                      **rand):
    """The bandpower conditional of ``megachain.py:102-145``: free bins
    ``beta / Gamma(alpha)``, bounded bins by table inversion. Pad bins
    carry ``beta = 0`` and so stay exactly 0. ``rand``: see
    :func:`rng_bandpower.bandpower`."""
    return impl.bandpower(beta, prior, tlog, q, **rand)


class _WarmStart:
    """Per-chain drift-gated Newton-Schulz warm start of the inverse,
    carried across the iterations of one chunk."""

    def __init__(self, warm_ns: int, drift_max: float, impl: Impl):
        self.impl = impl
        self.warm_ns = warm_ns
        self.drift_max = drift_max
        self.inv = None
        self.psx = None

    def __call__(self, s, ps, k: int):
        mm, herm_inv = self.impl.cgemm, self.impl.herm_inv
        if k == 0:
            inv = herm_inv(s)
        else:
            psx = self.psx
            tiny = torch.finfo(torch.float32).tiny
            rel = torch.abs(ps - psx) / (
                0.5 * (torch.abs(ps) + torch.abs(psx))
                + 1e-6 * torch.amax(psx, dim=1, keepdim=True) + tiny)
            drift = torch.amax(rel, dim=1)
            # rebuild unless drift is provably small: NaN <= x is False
            rebuild = torch.logical_not(drift <= self.drift_max)
            any_rebuild, any_ns = torch.stack(
                [rebuild.any(), torch.logical_not(rebuild).any()]).tolist()
            inv = self.inv
            if any_ns:
                for _ in range(self.warm_ns):
                    ex = mm(s, inv)
                    inv = mm(inv, ex, x=inv, alpha=-1.0, beta=2.0)
            if any_rebuild:
                exact = herm_inv(s)
                inv = exact if not any_ns else torch.where(
                    rebuild[:, None, None], exact, inv)
        self.inv = inv
        self.psx = ps
        return inv


def gcr_megachain(mops, tlog, q, ps0, k_total: int, *, nfreqs_true: int,
                  ntimes_true: int, alpha_int: int, all_unflagged: bool,
                  prior: PriorBins, refine: int = 1, warm_ns: int = 0,
                  drift_max: float = 0.25, lean: bool = False,
                  randomness: Optional[dict] = None, seed=None, sids=None,
                  iter0: int = 0, impl: Impl = KERNELS) -> ChainOut:
    """``k_total`` Gibbs iterations for the whole batch, starting from the
    padded bandpowers ``ps0`` (B, n).

    Randomness: ``randomness`` (external, per-iteration arrays with a
    leading K axis: complex64 ``oa``/``ob`` (K, B, n, t), ``gam`` (K, B, n),
    ``u_pb`` (K, B, >=8)), or the Philox streams of ``seed`` and the int32
    global chain ids ``sids`` at global iterations ``iter0 .. iter0+K-1``.
    ``impl``: the kernels (default) or ``impl.PLAIN``.
    """
    B, n = ps0.shape
    t = mops.nid.shape[2]
    m = mops.fg.shape[2]
    dev = ps0.device
    K = k_total
    if (randomness is None) == (sids is None or seed is None):
        raise ValueError("give either randomness, or seed and sids")
    out = dict(
        ps=torch.empty((K, B, n), dtype=torch.float32, device=dev),
        noise_nu=torch.empty((K, B, n), dtype=torch.float32, device=dev),
        bmask=torch.empty((K, B, n), dtype=torch.float32, device=dev))
    if lean:
        out["chit"] = torch.empty((K, B, n), dtype=torch.float32, device=dev)
    else:
        out["sig"] = torch.empty((K, B, n, t), dtype=torch.complex64,
                                 device=dev)
        out["amp"] = torch.empty((K, B, m, t), dtype=torch.complex64,
                                 device=dev)
        out["chi"] = torch.empty((K, B, n, t), dtype=torch.float32,
                                 device=dev)
    warm = _WarmStart(warm_ns, drift_max, impl) if warm_ns > 0 else None
    ps = ps0
    for k in range(K):
        g = iter0 + k
        if randomness is not None:
            oa, ob = randomness["oa"][k], randomness["ob"][k]
            rand = dict(gam=randomness["gam"][k],
                        u_pb=randomness["u_pb"][k])
        else:
            oa, ob = impl.rng_fields(seed, sids, g, n, t, ntimes_true,
                                     nfreqs_true)
            rand = dict(seed=seed, sids=sids, g=g, alpha=alpha_int)
        build_inv = None
        if warm is not None:
            build_inv = (lambda s, _ps=ps, _k=k: warm(s, _ps, _k))
        d = draw_body(
            mops, ps, oa, ob, nfreqs=nfreqs_true, ntimes=ntimes_true,
            all_unflagged=all_unflagged, refine=refine, build_inv=build_inv,
            lean=lean,
            sig_out=None if lean else out["sig"][k],
            amp_out=None if lean else out["amp"][k],
            chi_out=None if lean else out["chi"][k], impl=impl)
        ps = sample_bandpowers(d.beta, prior, tlog, q, impl, **rand)
        out["ps"][k] = ps
        out["noise_nu"][k] = d.noise_nu
        out["bmask"][k] = d.bmask
        if lean:
            out["chit"][k] = d.chit
    return ChainOut(sig=out.get("sig"), amp=out.get("amp"),
                    chi=out.get("chi"), chit=out.get("chit"), ps=out["ps"],
                    noise_nu=out["noise_nu"], bmask=out["bmask"],
                    ps_final=ps)
