"""The real engine: host-side chain operator build and the batch-first
Gibbs step (port of ``hydra_pspec_tpu/models/rgibbs.py``).

The host build is numpy, computed in float64 and stored at ``dtype``
(float32 by default, complex fields as complex64), exactly as the JAX
package stores them, including the dense-``Ninv`` noise path (``ni_dense``
and its Hermitian square root ``nih_dense`` by ``eigh``). The step runs in
torch on complex64 tensors in the reference layout ``(B, Ntimes,
Nfreqs)``, unpadded: the delay-basis GCR system ``(I + D P~ D) u = D F rc
+ omega_a`` (``gcr_solve``), then the bandpower draw. The engine serves
what the megachain engine does not: a dense ``Ninv``, MAP mode, and (in
``models/tflags.py``) more than 8 flag patterns.

Its products are the JAX package's XLA products, here the ``cgemm``
kernel (``impl.cgemm``; its plain version ``plain_cgemm`` on CPU tensors,
TF32 off). The solve is the solver menu of ``rgibbs.py:245-269``:
``pallas`` is the hand-written factor-solve kernel (``herm_chol_solve``),
``pallas2``/``pallas2f`` the ``herm_inv`` entry ``hermitian_solve``, and
``chol`` the same factor-solve in plain torch; ``auto`` is ``pallas`` on
the card and ``chol`` on the CPU, as in JAX. The omegas come from the
``rng_fields`` kernel and the bandpower draw from the ``bandpower`` kernel
(their plain versions on CPU tensors), on the Philox streams of
``ops/philox.py``.
"""
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.fourier import dft_matrix
from ..ops.invgamma import InvGammaTable, make_invgamma_table
from ..ops.kernels import herm_inv as _hi
from ..ops.kernels import spd_solve as _ss
from ..ops.kernels.cgemm import plain_cgemm
from ..ops.kernels.impl import KERNELS, Impl


class RChainOperators(NamedTuple):
    """Per-chain constants with a leading batch axis B. ``f`` and ``igt``
    are shared across the batch. Complex fields are complex numpy arrays;
    ``ni_dense``/``nih_dense`` are None for diagonal noise."""

    d_w: np.ndarray             # (B, Ntimes, Nfreqs) masked visibilities
    w: np.ndarray               # (B, Nfreqs) flags
    f: np.ndarray               # (Nfreqs, Nfreqs) centered DFT, shared
    ni_diag: np.ndarray         # (B, Nfreqs)
    nih_diag: np.ndarray        # (B, Nfreqs)
    ninv_full_diag: np.ndarray  # (B, Nfreqs)
    fg: np.ndarray              # (B, Nfreqs, Nmodes)
    ni_d: np.ndarray            # (B, Ntimes, Nfreqs) Ni (d - Fg a0)
    a0: np.ndarray              # (B, Ntimes, Nmodes) host GLS amplitudes
    p_tilde: np.ndarray         # (B, Nfreqs, Nfreqs) F (Ni - G (Ni Fg)^H) F^H / n
    g_mat: np.ndarray           # (B, Nfreqs, Nmodes) Ni Fg Maa^-1
    maa_inv: np.ndarray         # (B, Nmodes, Nmodes)
    igt: InvGammaTable          # shared
    ni_dense: Optional[np.ndarray] = None   # (B, Nfreqs, Nfreqs) masked Ni
    nih_dense: Optional[np.ndarray] = None  # (B, Nfreqs, Nfreqs) sqrtm(Ni)


def is_dense(ninv) -> bool:
    """True for an (Nfreqs, Nfreqs) ``Ninv`` with a non-zero off-diagonal
    entry (the dense noise path)."""
    ninv = np.asarray(ninv)
    return ninv.ndim == 2 and bool(
        np.abs(ninv - np.diag(np.diag(ninv))).max() > 0)


def build_chain_operators(vis, w, fgmodes, ninv,
                          dtype=np.float32) -> RChainOperators:
    """Build a batch-of-one chain. ``ninv``: scalar, (Nfreqs,) diagonal, or
    an (Nfreqs, Nfreqs) matrix; a genuinely dense one takes the dense path
    (``rgibbs.py:64-137``)."""
    vis = np.asarray(vis, dtype=np.complex128)
    nfreqs = vis.shape[-1]
    w = np.asarray(w, dtype=np.float64)
    ninv = np.asarray(ninv)
    ni_mat = nih_mat = None
    if is_dense(ninv):
        ninv_full = np.diagonal(ninv).real.astype(np.float64)
        ni_mat = (w[:, None] * np.asarray(ninv, dtype=np.complex128)) \
            * w[None, :]
        # the Hermitian PSD square root, once per chain (the reference
        # recomputes sqrtm every iteration, pspec.py:362)
        vals, vecs = np.linalg.eigh(ni_mat)
        nih_mat = (vecs * np.sqrt(np.clip(vals, 0.0, None))) @ vecs.conj().T
        ni = np.diagonal(ni_mat).real
        nih = np.sqrt(ni)   # kept for provenance; the dense path is used
    else:
        if ninv.ndim == 2:
            ninv = np.diag(ninv).real
        ninv_full = np.broadcast_to(np.real(ninv), (nfreqs,)).astype(
            np.float64)
        ni = w * ninv_full * w
        nih = np.sqrt(ni)
    fg = np.asarray(fgmodes, dtype=np.complex128)
    d_w = vis * w

    def apply_ni_rows(x):
        """Ni @ x^T as rows: x (..., Nfreqs)."""
        return ni * x if ni_mat is None else x @ ni_mat.T

    ni_fg = ni[:, None] * fg if ni_mat is None else ni_mat @ fg
    maa = fg.conj().T @ ni_fg
    # FG deflation: amplitudes are solved relative to the float64 GLS fit
    rhs0 = fg.conj().T @ apply_ni_rows(d_w).T
    a0 = np.linalg.lstsq(maa, rhs0, rcond=None)[0].T
    d_defl = d_w - a0 @ fg.T
    ni_d = apply_ni_rows(d_defl)
    maa_inv = np.linalg.pinv(maa)
    g_mat = ni_fg @ maa_inv
    p_base = np.diag(ni).astype(complex) if ni_mat is None else ni_mat
    p_mat = p_base - g_mat @ ni_fg.conj().T
    i_idx = np.arange(nfreqs) - nfreqs // 2
    f_op = np.exp(-2j * np.pi * np.outer(i_idx, i_idx) / nfreqs)
    p_tilde = f_op @ p_mat @ f_op.conj().T / nfreqs

    # complex128 -> complex64 rounds each part to nearest, as the JAX
    # package's separate float32 casts of re and im do
    cdt = np.result_type(dtype, np.complex64)
    cv = lambda z: np.asarray(z)[None].astype(cdt)
    rv = lambda x: np.asarray(np.asarray(x)[None], dtype=dtype)
    return RChainOperators(
        d_w=cv(d_w), w=rv(w), f=dft_matrix(nfreqs, dtype=dtype),
        ni_diag=rv(ni), nih_diag=rv(nih), ninv_full_diag=rv(ninv_full),
        fg=cv(fg), ni_d=cv(ni_d), a0=cv(a0), p_tilde=cv(p_tilde),
        g_mat=cv(g_mat), maa_inv=cv(maa_inv),
        igt=make_invgamma_table(vis.shape[0], dtype=dtype),
        ni_dense=None if ni_mat is None else cv(ni_mat),
        nih_dense=None if nih_mat is None else cv(nih_mat),
    )


_SHARED = ("f", "igt")
_DENSE = ("ni_dense", "nih_dense")


def stack_chain_operators(ops_list) -> RChainOperators:
    """Concatenate batches of chains along the batch axis; the shared
    fields come from the first element. Dense and diagonal noise do not
    mix in one batch (as in the JAX package)."""
    dense = {o.ni_dense is not None for o in ops_list}
    if len(dense) > 1:
        raise ValueError("a batch mixes dense and diagonal Ninv")
    fields = {name: np.concatenate([getattr(o, name) for o in ops_list])
              for name in RChainOperators._fields
              if name not in _SHARED + (() if dense == {True} else _DENSE)}
    return RChainOperators(**fields, f=ops_list[0].f, igt=ops_list[0].igt)


# --- the step, on the device -------------------------------------------------

class RealOperators(NamedTuple):
    """:class:`RChainOperators` as tensors on one device (complex64 and
    float32), with the per-time fields time-transposed to (B, Nfreqs or
    Nmodes, Ntimes) so that every product is a ``cgemm`` and every sum over
    times a per-row ``row_scale_sumsq``; ``tlog``/``q`` are the inverse-gamma
    table rows."""

    dw_t: torch.Tensor           # (B, Nfreqs, Ntimes) masked visibilities
    w: torch.Tensor
    f: torch.Tensor
    ni_diag: torch.Tensor
    nih_diag: torch.Tensor
    ninv_full_diag: torch.Tensor
    fg: torch.Tensor
    nid_t: torch.Tensor          # (B, Nfreqs, Ntimes)
    a0_t: torch.Tensor           # (B, Nmodes, Ntimes)
    p_tilde: torch.Tensor
    g_mat: torch.Tensor
    maa_inv: torch.Tensor
    tlog: torch.Tensor
    q: torch.Tensor
    ni_dense: Optional[torch.Tensor]
    nih_dense: Optional[torch.Tensor]


_TIME_MAJOR = {"d_w": "dw_t", "ni_d": "nid_t", "a0": "a0_t"}


def to_device(ops: RChainOperators, device) -> RealOperators:
    """Host operators -> :class:`RealOperators` on ``device``."""
    def t(x, transpose=False):
        if x is None:
            return None
        x = np.swapaxes(x, 1, 2) if transpose else x
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    fields = {_TIME_MAJOR.get(name, name): t(getattr(ops, name),
                                             name in _TIME_MAJOR)
              for name in RChainOperators._fields if name != "igt"}
    return RealOperators(**fields, tlog=t(np.asarray(ops.igt.log_y)),
                         q=t(np.asarray(ops.igt.q)))


class RealSample(NamedTuple):
    """One step's sample in the reference layout (leading batch axis)."""

    signal_cr: torch.Tensor   # (B, Ntimes, Nfreqs) complex
    ps: torch.Tensor          # (B, Nfreqs)
    fg_amps: torch.Tensor     # (B, Ntimes, Nmodes) complex
    chisq: torch.Tensor       # (B, Ntimes, Nfreqs)
    ln_post: torch.Tensor     # (B,)
    chisq_mean: torch.Tensor  # (B,) mean of chisq (the lean sample)


class Draw(NamedTuple):
    """One GCR draw in the time-transposed layout."""

    sig_t: torch.Tensor       # (B, Nfreqs, Ntimes) signal
    fga_t: torch.Tensor       # (B, Nmodes, Ntimes) foreground amplitudes
    sk_t: torch.Tensor        # (B, Nfreqs, Ntimes) delay transform
    beta: torch.Tensor        # (B, Nfreqs) sum over times of |sk|^2


def _t(x):
    return x.transpose(-1, -2)


def row_sum(v):
    """Sum over the last axis in a fixed pairwise order (zero-padded to a
    power of two), by elementwise adds only. A reduction kernel on the card
    may split a row differently for another batch size; this sum depends
    on the row alone, so a chain's ln-posterior does not change with the
    chains beside it."""
    n = v.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        v = torch.nn.functional.pad(v, (0, width - n))
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v[..., :half] + v[..., half:]
    return v[..., 0]


def _abs2(z):
    return z.real * z.real + z.imag * z.imag


def draw(ops: RealOperators, ps, oa_t=None, ob_t=None, jitter: float = 0.0,
         solver: str = "auto", impl: Impl = KERNELS) -> Draw:
    """The GCR draw of ``rgibbs.py:173-242`` in the time-transposed layout:
    ``(I + D P~ D) u = D F rc_red + omega_a`` with ``D = diag(sqrt(ps /
    n))``, on contiguous omegas ``oa_t``/``ob_t`` (B, Nfreqs, Ntimes), or
    None for the MAP draw. Products are ``impl.cgemm``, the solve
    :func:`solve`, and ``sk``/``beta`` one ``impl.row_scale_sumsq``; each
    chain's result depends on that chain alone."""
    mm = impl.cgemm
    nfreqs = ops.f.shape[0]
    dd = torch.sqrt(torch.clamp(ps, min=0.0) / nfreqs)        # (B, n)
    eye = torch.eye(nfreqs, dtype=ops.p_tilde.dtype, device=ps.device)
    s_u = (dd[:, :, None] * dd[:, None, :]) * ops.p_tilde + eye

    if ob_t is None:
        rc_t = ops.nid_t
    elif ops.nih_dense is not None:
        # (w_b conj(Nih))^T = Nih^H w_b^T (rgibbs.py:214-216)
        rc_t = mm(ops.nih_dense, ob_t, op="H", x=ops.nid_t)
    else:
        rc_t = ops.nid_t + ops.nih_diag[:, :, None] * ob_t
    b_a = mm(ops.fg, rc_t, op="H")                            # (B, m, T)
    rc_red = mm(ops.g_mat, b_a, x=rc_t, alpha=-1.0)
    b_u = dd[:, :, None] * mm(ops.f, rc_red)
    if oa_t is not None:
        b_u = b_u + oa_t
    u = solve(s_u, b_u, jitter, solver, impl)
    sk_t, beta = impl.row_scale_sumsq(u, dd)                 # F s, delay
    sig_t = mm(ops.f, sk_t, op="H", alpha=1.0 / nfreqs)      # F^H sk / n
    amps_t = mm(ops.g_mat, sig_t, op="H", x=mm(ops.maa_inv, b_a),
                alpha=-1.0)
    return Draw(sig_t, amps_t + ops.a0_t, sk_t, beta)


def gcr_solve(ops: RealOperators, ps, omega_a_delay=None, omega_b=None,
              jitter: float = 0.0, solver: str = "auto",
              impl: Impl = KERNELS):
    """Constrained-realization draw for every (chain, time) at once, in the
    reference layout (``rgibbs.py:173-242``). ``ps`` (B, Nfreqs);
    ``omega_b`` (B, Ntimes, Nfreqs) standard complex normal,
    ``omega_a_delay`` the same shape with covariance ``n I``; None for both
    is the MAP draw. Returns ``(signal_cr, fg_amps, sk)``, ``sk`` the
    centered delay transform of the signal (B, Ntimes, Nfreqs)."""
    tt = lambda z: None if z is None else _t(z).contiguous()
    d = draw(ops, ps, tt(omega_a_delay), tt(omega_b), jitter, solver, impl)
    return _t(d.sig_t), _t(d.fga_t), _t(d.sk_t)


def solve(m, b, jitter: float, solver: str, impl: Impl = KERNELS):
    """``m x = b`` for the Hermitian PD systems ``m`` (B, n, n), ``b``
    (B, n, K): the solver menu of ``rgibbs.py:245-269``. ``recinv`` is
    :func:`herm_inv.hermitian_solve` (equilibration, the explicit inverse,
    one refinement step) over the plain ``herm_inv`` and ``cgemm``, as the
    JAX package's ``cplx.hermitian_solve_recinv`` is the recursive-inverse
    kernel's algorithm in XLA; ``identity`` returns ``b`` (profiling
    only, as in the JAX package)."""
    if solver == "auto":
        solver = "pallas" if m.device.type == "cuda" else "chol"
    if solver == "chol":
        return _ss.hermitian_solve_chol(m, b, jitter,
                                        solve=_ss.plain_herm_chol_solve)
    if solver == "pallas":
        return _ss.hermitian_solve_chol(m, b, jitter,
                                        solve=impl.herm_chol_solve)
    if solver in ("pallas2", "pallas2f"):
        return _hi.hermitian_solve(m, b, refine=2 if solver == "pallas2f"
                                   else 1, jitter=jitter,
                                   inv=impl.herm_inv, mm=impl.cgemm)
    if solver == "recinv":
        # the JAX solver is the recursive-inverse kernel's algorithm in XLA,
        # without the kernel: here the same entry over the plain versions
        return _hi.hermitian_solve(m, b, refine=1, jitter=jitter,
                                   inv=_hi.plain_herm_inv, mm=plain_cgemm)
    if solver == "identity":    # profiling only: no solve at all
        return b
    raise ValueError(f"unknown solver {solver!r}")


def omegas_t(rand: dict, ntimes: int, nfreqs: int, impl: Impl,
             segments=None):
    """One iteration's omegas in the time-transposed layout, complex64:
    the pair ``(oa_t, ob_t)`` (B, Nfreqs, Ntimes), or with ``segments``
    (the grouped engine's time groups, ``rng_bandpower.TimeSegments``) a
    list of each group's pair (B, Nfreqs, t_g), the omegas at its times.
    From external ``oa``/``ob`` (B, Ntimes, Nfreqs) transposed (and
    gathered at each group's times), or drawn on the streams at ``(i =
    frequency, j = time)`` (``ops/philox.py``): one ``rng_fields`` launch,
    or one ``rng_segments`` launch for all the groups, each at its own
    width."""
    if "oa" in rand:
        oa, ob = (_t(rand[k]).contiguous() for k in ("oa", "ob"))
        if segments is None:
            return oa, ob
        return [(oa[:, :, ix], ob[:, :, ix]) for ix in segments.idx]
    if segments is None:
        return impl.rng_fields(rand["seed"], rand["sids"], rand["g"], nfreqs,
                               ntimes, ntimes, nfreqs)
    oa, ob = impl.rng_segments(rand["seed"], rand["sids"], rand["g"], nfreqs,
                               segments, nfreqs)
    return list(zip(oa, ob))


def bandpower_args(rand: dict, alpha: int) -> dict:
    """Keyword arguments of ``impl.bandpower`` from one iteration's
    randomness: external ``gam``/``u_pb``, or ``seed``/``sids``/``g`` (and
    an optional ``g_off``)."""
    if "gam" in rand:
        return dict(gam=rand["gam"], u_pb=rand["u_pb"])
    return dict(seed=rand["seed"], sids=rand["sids"], g=rand["g"],
                g_off=rand.get("g_off", 0), alpha=alpha)


class Residual(NamedTuple):
    """The statistics of one draw's residual ``d - s - a Fg^T``."""

    chi_t: torch.Tensor       # (B, Nfreqs, Ntimes) |r|^2 Ninv_full diag
    noise: torch.Tensor       # (B,) Re(r^H Ni r) summed over times
    chi_sum: torch.Tensor     # (B,) chi summed over times and channels
    beta_masked: torch.Tensor  # (B, Nfreqs) sum over times of |F(w s)|^2


def residual(ops: RealOperators, d: Draw, *, dense_noise: bool,
             all_unflagged: bool, impl: Impl = KERNELS) -> Residual:
    """``rgibbs.py:321-360``: chi^2 against the unmasked noise diagonal,
    also for dense noise (the reference's statistic); the ln-posterior
    noise term ``Re(r^H Ni r) = |Nih r|^2`` with the dense square root when
    ``dense_noise``, else with the diagonal of ``Ni``; the masked delay
    power ``beta`` itself when ``all_unflagged``."""
    mm = impl.cgemm
    resid_t = ops.dw_t - mm(ops.fg, d.fga_t, x=d.sig_t)
    chi_t = _abs2(resid_t) * ops.ninv_full_diag[:, :, None]
    _, r2 = impl.row_scale_sumsq(resid_t, want_y=False)      # (B, n)
    if dense_noise:
        _, nr2 = impl.row_scale_sumsq(mm(ops.nih_dense, resid_t),
                                      want_y=False)
        noise = row_sum(nr2)
    else:
        noise = row_sum(ops.ni_diag * r2)
    if all_unflagged:
        bm = d.beta
    else:
        _, bm = impl.row_scale_sumsq(
            mm(ops.f, ops.w[:, :, None] * d.sig_t, op="T"), want_y=False)
    return Residual(chi_t, noise, row_sum(ops.ninv_full_diag * r2), bm)


def sig_term(beta_masked, ps_new):
    """``sum |F(w s)|^2 / ps`` per chain, from the per-bin sums."""
    tiny = torch.finfo(torch.float32).tiny
    return row_sum(beta_masked / torch.clamp(ps_new, min=tiny))


def gibbs_step(ops: RealOperators, ps, prior, rand: dict, *,
               map_estimate: bool = False, jitter: float = 0.0,
               solver: str = "auto", all_unflagged: bool = False,
               impl: Impl = KERNELS):
    """One Gibbs alternation for the whole batch (``rgibbs.py:272-363``).
    ``prior``: the bounded bins (``rng_bandpower.PriorBins``). ``rand``:
    this iteration's randomness, external (``oa``, ``ob`` complex (B,
    Ntimes, Nfreqs), ``gam`` (B, Nfreqs), ``u_pb`` (B, >= bounded bins)) or
    the streams ``seed``, ``sids`` (int32 chain ids), ``g`` (global
    iteration). Returns ``(ps_new, RealSample)``."""
    nfreqs, ntimes = ops.dw_t.shape[1:]
    oa_t = ob_t = None
    if not map_estimate:
        oa_t, ob_t = omegas_t(rand, ntimes, nfreqs, impl)
    d = draw(ops, ps, oa_t, ob_t, jitter, solver, impl)
    ps_new = impl.bandpower(d.beta, prior, ops.tlog, ops.q,
                            **bandpower_args(rand, ntimes - 1))
    r = residual(ops, d, dense_noise=ops.ni_dense is not None,
                 all_unflagged=all_unflagged, impl=impl)
    ln_post = -(r.noise + sig_term(r.beta_masked, ps_new))
    return ps_new, RealSample(_t(d.sig_t), ps_new, _t(d.fga_t), _t(r.chi_t),
                              ln_post, r.chi_sum / (ntimes * nfreqs))


def iteration_randomness(randomness: Optional[dict], k: int, seed, sids,
                         g: int) -> dict:
    """Iteration ``k`` of a chunk's external randomness (leading K axis),
    or the stream arguments of global iteration ``g``."""
    if randomness is None:
        return dict(seed=seed, sids=sids, g=g)
    return {name: v[k] for name, v in randomness.items()}


class ChainSample(NamedTuple):
    """Samples stacked over iterations, in the reference layout (every
    engine's chunk result). Lean runs carry None for the per-time fields
    and a scalar chi^2 mean per iteration."""

    signal_cr: Optional[torch.Tensor]   # (K, B, Ntimes, Nfreqs) complex
    ps: torch.Tensor                    # (K, B, Nfreqs)
    fg_amps: Optional[torch.Tensor]     # (K, B, Ntimes, Nmodes) complex
    chisq: torch.Tensor                 # (K, B, Ntimes, Nfreqs) or (K, B)
    ln_post: torch.Tensor               # (K, B)


def append_sample(parts: dict, s: RealSample, store_cr: bool):
    """Add one step's sample to the per-field lists of a chunk."""
    parts["ps"].append(s.ps)
    parts["ln_post"].append(s.ln_post)
    if store_cr:
        parts["signal_cr"].append(s.signal_cr)
        parts["fg_amps"].append(s.fg_amps)
        parts["chisq"].append(s.chisq)
    else:
        parts["chisq"].append(s.chisq_mean)


def stack_samples(parts: dict) -> ChainSample:
    """Per-field lists -> :class:`ChainSample` (None where empty)."""
    return ChainSample(**{name: torch.stack(v) if v else None
                          for name, v in parts.items()})


def run_chain(ops: RealOperators, ps0, prior, niter: int, *, seed=None,
              sids=None, iter0: int = 0, randomness: Optional[dict] = None,
              map_estimate: bool = False, jitter: float = 0.0,
              store_cr: bool = True, solver: str = "auto",
              all_unflagged: bool = False, impl: Impl = KERNELS):
    """``niter`` steps from ``ps0`` (B, Nfreqs) (``rgibbs.py:366-391``, a
    Python loop). Randomness: ``randomness`` (the chunk's external arrays
    as complex64/float32 tensors with a leading K axis, see
    :func:`gibbs_step`), or the Philox streams of ``seed`` and the int32
    chain ids ``sids`` at global iterations ``iter0 ..``. Returns
    ``(ps_final, ChainSample)`` with iterations on axis 0; lean runs
    (``store_cr=False``) carry the chi^2 mean per iteration."""
    ps = ps0
    parts = {name: [] for name in ChainSample._fields}
    for k in range(niter):
        rand = iteration_randomness(randomness, k, seed, sids, iter0 + k)
        ps, s = gibbs_step(ops, ps, prior, rand, map_estimate=map_estimate,
                           jitter=jitter, solver=solver,
                           all_unflagged=all_unflagged, impl=impl)
        append_sample(parts, s, store_cr)
    return ps, stack_samples(parts)
