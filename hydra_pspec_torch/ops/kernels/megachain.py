"""K whole Gibbs iterations per chain: the port of the TPU kernel
``ops/pallas/megachain.py::gcr_megachain`` (:469-694), in plain and in
grouped time-flags mode.

On the TPU this is one Pallas program that keeps every chain's constants
in VMEM for K iterations. Here each iteration is a short sequence of the
hand-written kernels (:mod:`megastep`), with the bandpower state carried
on the device:

* the omegas from the per-row Philox streams, drawn inside ``draw_rhs``
  and ``draw_system`` (:class:`draw_fused.OmegaKey`; no ``rng_fields``
  launch), or external randomness;
* the drift-gated Newton-Schulz warm start of the system inverse
  (:349-397), decided per chain on the device, as the TPU kernel decides
  it with ``pl.when``: NS refresh ``X <- X (2I - S X)`` on every chain,
  then the exact inverse over it for the chains whose relative bandpower
  move is not provably small (NaN-safe; the gate is computed inside the
  masked ``herm_inv`` launch), and for all at the chunk's first
  iteration. Nothing reads back to the host,
  so a chunk can be captured as one CUDA graph (:mod:`graph`);
* :func:`megastep.draw_body`;
* the bandpower conditional (:func:`sample_bandpowers`).

``lean`` returns only the time-reduced chi and the per-iteration vectors.

Grouped time-flags mode (``group = G > 1``, :153-163): each chain spans G
chain-major rows, row ``c*G + g`` carrying the operators of flag-pattern
time group g and its time count in ``row_times``. The omegas are drawn per
row, ``beta`` is pooled over a chain's rows inside the bandpower kernel,
and every row of a chain gets the chain's ``ps``, so the warm-start gate
takes the same decision on all of them. With a :class:`TimeScatter` the
per-time fields of each iteration are gathered at once into per-chain
outputs in the original time order (the XLA scatters of
``models/megachain.py:443-451``), so the padded per-row fields never
outlive their iteration.
"""
from typing import NamedTuple, Optional

import torch

from .draw_fused import OmegaKey
from .impl import KERNELS, Impl
from .megastep import draw_body
from .rng_bandpower import PriorBins


class TimeScatter(NamedTuple):
    """Where each true time of a chain lies in its G rows: time T is lane
    ``lane[T]`` of row ``c*G + row[T]``."""

    group: int
    row: torch.Tensor    # (Ntimes,) int64
    lane: torch.Tensor   # (Ntimes,) int64
    nfreqs: int
    nmodes: int

    def gather(self, x, width: int):
        """(Bc*G, r, t) rows -> (Bc, Ntimes, width) per chain, time-major."""
        xv = x.view(-1, self.group, x.shape[1], x.shape[2])
        return xv.transpose(2, 3)[:, self.row, self.lane, :width]


class ChainOut(NamedTuple):
    """Per-iteration outputs with a leading K axis (padded layout; with a
    :class:`TimeScatter` the per-time fields are per chain, time-major and
    trimmed: (K, Bc, Ntimes, Nfreqs or Nmodes))."""

    sig: Optional[torch.Tensor]     # (K, B, n, t) complex; None when lean
    amp: Optional[torch.Tensor]     # (K, B, m, t) complex; None when lean
    chi: Optional[torch.Tensor]     # (K, B, n, t); None when lean
    chit: Optional[torch.Tensor]    # (K, B, n); lean only
    ps: torch.Tensor                # (K, B, n)
    noise_nu: torch.Tensor          # (K, B, n)
    bmask: torch.Tensor             # (K, B, n)
    ps_final: torch.Tensor          # (B, n)


def chain_outputs(K: int, B: int, n: int, t: int, m: int, lean: bool, dev,
                  scatter: Optional[TimeScatter] = None) -> dict:
    """The K-slot outputs of a chunk (:class:`ChainOut` but ``ps_final``),
    allocated once: the kernels write each iteration into its slot."""
    f32, c64 = torch.float32, torch.complex64
    out = {name: torch.empty((K, B, n), dtype=f32, device=dev)
           for name in ("ps", "noise_nu", "bmask")}
    out.update(sig=None, amp=None, chi=None, chit=None)
    if lean:
        out["chit"] = torch.empty((K, B, n), dtype=f32, device=dev)
    elif scatter is not None:
        bc, nt = B // scatter.group, scatter.row.shape[0]
        nf, nm = scatter.nfreqs, scatter.nmodes
        out["sig"] = torch.empty((K, bc, nt, nf), dtype=c64, device=dev)
        out["amp"] = torch.empty((K, bc, nt, nm), dtype=c64, device=dev)
        out["chi"] = torch.empty((K, bc, nt, nf), dtype=f32, device=dev)
    else:
        out["sig"] = torch.empty((K, B, n, t), dtype=c64, device=dev)
        out["amp"] = torch.empty((K, B, m, t), dtype=c64, device=dev)
        out["chi"] = torch.empty((K, B, n, t), dtype=f32, device=dev)
    return out


def sample_bandpowers(beta, prior: PriorBins, tlog, q, impl=KERNELS,
                      **rand):
    """The bandpower conditional of ``megachain.py:102-145``: free bins
    ``beta / Gamma(alpha)``, bounded bins by table inversion. Pad bins
    carry ``beta = 0`` and so stay exactly 0. ``rand``: see
    :func:`rng_bandpower.bandpower`."""
    return impl.bandpower(beta, prior, tlog, q, **rand)


class _WarmStart:
    """Per-chain drift-gated Newton-Schulz warm start of the inverse,
    carried across the iterations of one chunk, with no host sync.

    The NS products run on every chain; a chain's products depend on that
    chain alone, so refreshing one that then rebuilds changes no kept bit.
    ``herm_inv`` in gate mode decides in each chain's block which chains
    rebuild and writes their exact inverse over the refreshed one (the
    other chains' blocks return at once). The chunk's first iteration
    (k == 0, static in a graph) rebuilds every chain."""

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
            inv = self.inv
            for _ in range(self.warm_ns):
                ex = mm(s, inv)
                inv = mm(inv, ex, x=inv, alpha=-1.0, beta=2.0)
            inv = herm_inv(s, out=inv, gate=(ps, self.psx, self.drift_max))
        self.inv = inv
        self.psx = ps
        return inv


def gcr_megachain(mops, tlog, q, ps0, k_total: int, *, nfreqs_true: int,
                  ntimes_true: int, alpha_int: int, all_unflagged: bool,
                  prior: PriorBins, refine: int = 1, warm_ns: int = 0,
                  drift_max: float = 0.25, lean: bool = False,
                  randomness: Optional[dict] = None, seed=None, sids=None,
                  iter0: int = 0, row_times=None, group: int = 1,
                  sidc=None, scatter: Optional[TimeScatter] = None,
                  impl: Impl = KERNELS) -> ChainOut:
    """``k_total`` Gibbs iterations for the whole batch, starting from the
    padded bandpowers ``ps0`` (B, n).

    Randomness: ``randomness`` (external, per-iteration arrays with a
    leading K axis: complex64 ``oa``/``ob`` (K, B, n, t), ``gam`` (K, B, n),
    ``u_pb`` (K, B, >=8)), or the Philox streams of ``seed`` and the int32
    global chain ids ``sids`` at global iterations ``iter0 .. iter0+K-1``
    (``iter0`` an int, or a (1,) int32 tensor on the device that the keyed
    kernels read when they run: a graph replay's counter).
    Grouped mode (``group`` G > 1): ``sids`` are the row streams, ``sidc``
    (B,) each row's chain id, ``row_times`` (B,) int32 each row's time
    count; ``scatter`` (optional, full mode) gathers the per-time fields
    into per-chain outputs. ``impl``: the kernels (default) or
    ``impl.PLAIN``.
    """
    B, n = ps0.shape
    t = mops.nid.shape[2]
    m = mops.fg.shape[2]
    dev = ps0.device
    K = k_total
    if (randomness is None) == (sids is None or seed is None):
        raise ValueError("give either randomness, or seed and sids")
    if group > 1 and (row_times is None
                      or (randomness is None and sidc is None)):
        raise ValueError("grouped mode needs row_times, and sidc with seed")
    out = chain_outputs(K, B, n, t, m, lean, dev, scatter)
    direct = not lean and scatter is None   # kernels write into out[...][k]
    warm = _WarmStart(warm_ns, drift_max, impl) if warm_ns > 0 else None
    ps = ps0
    for k in range(K):
        key = None
        if randomness is not None:
            oa, ob = randomness["oa"][k], randomness["ob"][k]
            rand = dict(gam=randomness["gam"][k],
                        u_pb=randomness["u_pb"][k])
        else:
            oa = ob = None
            key = OmegaKey(seed, sids, iter0, k)
            rand = dict(seed=seed, sids=sids if group == 1 else sidc,
                        g=iter0, g_off=k, alpha=alpha_int)
        build_inv = None
        if warm is not None:
            build_inv = (lambda s, _ps=ps, _k=k: warm(s, _ps, _k))
        d = draw_body(
            mops, ps, oa, ob, nfreqs=nfreqs_true, ntimes=ntimes_true,
            all_unflagged=all_unflagged, refine=refine, build_inv=build_inv,
            lean=lean,
            sig_out=out["sig"][k] if direct else None,
            amp_out=out["amp"][k] if direct else None,
            chi_out=out["chi"][k] if direct else None,
            row_times=row_times, key=key, impl=impl)
        if scatter is not None and not lean:
            out["sig"][k] = scatter.gather(d.sig, scatter.nfreqs)
            out["amp"][k] = scatter.gather(d.amp, scatter.nmodes)
            out["chi"][k] = scatter.gather(d.chi, scatter.nfreqs)
        ps = sample_bandpowers(d.beta, prior, tlog, q, impl, group=group,
                               **rand)
        out["ps"][k] = ps
        out["noise_nu"][k] = d.noise_nu
        out["bmask"][k] = d.bmask
        if lean:
            out["chit"][k] = d.chit
    return ChainOut(ps_final=ps, **out)
