"""One GCR draw plus its statistics: phases 1-6 of
``ops/pallas/megastep.py::_draw_body`` (:111-235), composed from the
hand-written kernels, and the standalone single-step entry
:func:`gcr_megastep` (``megastep.py:303-409``) of the mega engine.

Every matrix product goes through :func:`cgemm`, the system inverse
through :func:`herm_inv`, and every ``(B, n, t)`` elementwise or reduction
pass through :mod:`draw_fused`. On CPU tensors each of those takes its
plain torch version, so this one function is both the CUDA path and the
CPU reference.

Phases (all fields in the time-transposed (B, n, t) layout, complex64):
  1. ``rc = ni_d + nih omega_b``                          draw_rhs
  2. ``b_a = Fg^H rc``; ``rc -= G b_a``                    cgemm x2
  3. ``frc = F rc``                                        cgemm
  4. ``S = I + D P~ D`` equilibrated, ``xs`` its RHS      draw_system
     ``S^-1`` (or the caller's warm start), apply, refine herm_inv, cgemm
  5. ``sk = dd u``, ``beta``; ``sig = F^H sk / n``;
     ``amps = Maa^-1 b_a - G^H sig + a0``               row_scale_sumsq, cgemm
  6. FG-deflated residual -> chi, noise_nu, bmask        cgemm, draw_resid
"""
from typing import NamedTuple, Optional

import torch

from . import _build
from .draw_fused import OmegaKey
from .herm_inv import apply_refine
from .impl import KERNELS, Impl


class DrawOut(NamedTuple):
    sig: Optional[torch.Tensor]    # (B, n, t) complex, full mode
    amp: Optional[torch.Tensor]    # (B, m, t) complex, full mode
    chi: Optional[torch.Tensor]    # (B, n, t), full mode
    chit: Optional[torch.Tensor]   # (B, n) chi summed over true times, lean
    beta: torch.Tensor             # (B, n)
    noise_nu: torch.Tensor         # (B, n)
    bmask: torch.Tensor            # (B, n)


def draw_body(mops, ps, oa, ob, *, nfreqs: int, ntimes: int,
              all_unflagged: bool, refine: int = 1, build_inv=None,
              lean: bool = False, sig_out=None, amp_out=None,
              chi_out=None, row_times=None, key: Optional[OmegaKey] = None,
              impl: Impl = KERNELS) -> DrawOut:
    """One draw for the batch. ``mops``: :class:`models.mega.MegaOperators`;
    ``ps`` (B, n) float32; ``oa``/``ob`` (B, n, t) complex64 omegas (the
    kernel masks them at ``ntimes``, or with the int32 ``row_times`` (B,)
    of the grouped time-flags mode at each row's own count, as
    ``megastep.py:135-157`` does with ``tmask``), or ``None`` for both and
    the :class:`OmegaKey` ``key``: ``draw_rhs`` and ``draw_system`` then
    draw the omegas they consume (the same words and bits as the fields of
    ``rng_fields``). ``build_inv(S)``:
    optional policy returning the system inverse (the megachain warm
    start); default is the exact inverse. ``*_out``: optional preallocated
    full-mode outputs. ``impl``: the kernels (default) or the plain
    versions (``impl.PLAIN``)."""
    mm = impl.cgemm
    # 1-3. right-hand side, FG Schur reduction, delay basis
    if (oa is None) != (ob is None):
        raise ValueError("give both oa and ob, or neither and key")
    rc = impl.draw_rhs(mops.nid, mops.nih, ob, ntimes, row_times, key)
    ba = mm(mops.fg, rc, op="H")
    rc = mm(mops.g, ba, x=rc, alpha=-1.0, beta=1.0, out=rc)
    frc = mm(mops.f, rc)

    # 4. equilibrated system, inverse, apply + refinement
    s, xs, dd, dinv = impl.draw_system(mops.pt, ps, frc, oa, ntimes, nfreqs,
                                       row_times, key)
    inv = impl.herm_inv(s) if build_inv is None else build_inv(s)
    x = apply_refine(s, inv, xs, refine, mm=mm)

    # 5. delay statistics, back-transform, amplitudes
    sk, beta = impl.row_scale_sumsq(x, dinv, dd)
    sig = mm(mops.f, sk, op="H", alpha=1.0 / nfreqs, out=sig_out)
    ma = mm(mops.mi, ba)
    da = mm(mops.g, sig, op="H", x=ma, alpha=-1.0, beta=1.0, out=ma)

    # 6. residual against the FG-deflated data
    fa = mm(mops.fg, da)
    chi, noise_nu, chit, amp, ws = impl.draw_resid(
        mops.dw, sig, fa, mops.ninv_full, mops.w, da, mops.a0, ntimes,
        want_chi=not lean, want_chit=lean, want_amp=not lean,
        want_ws=not all_unflagged, chi_out=chi_out, amp_out=amp_out,
        row_times=row_times)
    if all_unflagged:
        bmask = beta
    else:
        _, bmask = impl.row_scale_sumsq(mm(mops.f, ws), want_y=False)
    return DrawOut(None if lean else sig, amp, chi, chit, beta, noise_nu,
                   bmask)


def gcr_megastep(mops, ps, oa, ob, *, nfreqs: int, ntimes: int,
                 all_unflagged: bool, refine: int = 1, lean: bool = False,
                 key: Optional[OmegaKey] = None, impl: Impl = KERNELS,
                 sig_out=None, amp_out=None, chi_out=None) -> DrawOut:
    """One GCR draw plus its statistics for the whole batch: the port of
    the standalone TPU entry ``ops/pallas/megastep.py::gcr_megastep``
    (:303-409, ``_mega_kernel``), the mega engine's step.

    It is :func:`draw_body` with the exact ``herm_inv`` inverse and
    ``refine`` refinement steps, on explicit omegas ``oa``/``ob`` (B, n, t)
    or on the Philox streams of ``key`` (the engine's way: ``draw_rhs`` and
    ``draw_system`` draw them in registers, which takes the place of the
    TPU entry's in-kernel RNG mode: that mode's streams were seeded per
    grid step and were not invariant to batch composition). Full mode
    returns the JAX entry's 8 outputs in :class:`DrawOut`: ``sig`` and
    ``amp`` complex (the ``_re``/``_im`` pairs), ``chi``, ``beta``,
    ``noise_nu`` and ``bmask``; ``lean`` returns the time-reduced ``chit``
    instead of ``sig``, ``amp`` and ``chi``; ``*_out``: optional
    preallocated full-mode outputs. Each call on the card with the kernels
    counts one ``gcr_megastep`` launch."""
    if impl is KERNELS and ps.device.type == "cuda":
        _build.count_entry("gcr_megastep")
    return draw_body(mops, ps, oa, ob, nfreqs=nfreqs, ntimes=ntimes,
                     all_unflagged=all_unflagged, refine=refine, lean=lean,
                     sig_out=sig_out, amp_out=amp_out, chi_out=chi_out,
                     key=key, impl=impl)
