"""The elementwise and row-reduction passes of one GCR draw.

Kernels: ``csrc/draw_fused.cu`` (CUDA C++, not Triton). They replace the
VPU phases of ``ops/pallas/megastep.py::_draw_body``: the right-hand side
(:139-142), the equilibrated system and scaled RHS (:153-174), ``beta``
(:199-201), the residual statistics (:221-234) and the lean ``chi_t``
(``ops/pallas/megachain.py:427-434``). Each is a streaming pass over
``(B, n, t)`` complex fields. ``row_scale_sumsq`` and ``draw_resid`` take
4, 8 or 32 lanes of a warp a row (from ``t`` alone) and four time lanes a
thread; a row's sum is reduced by shuffles in the fixed tree of a
256-thread block reduction, so the bits do not depend on the batch.
``draw_rhs`` and ``draw_system`` take four time lanes a thread over the
flat (row, lane) space, in 16-byte pairs where ``t`` is even; keyed, they
are bound by the instructions of the Philox and Box-Muller draws, which
the four lanes of a thread share where they can. ``draw_system`` computes
``dd`` and ``dinv`` once per chain: a chain's rows go to a cluster of
blocks that share those values through distributed shared memory. Pad
lanes (``j`` at or above a row's time count) are written as zeros without
being read: the layout (``models/mega.py``) holds zeros in every input
there, so the plain versions give zeros there too.

The time mask is ``j < ntimes``; in the grouped time-flags mode the
optional int32 ``row_times`` (B,) gives each row its own count instead.

Omegas: ``draw_rhs`` and ``draw_system`` take the stored fields ``ob`` /
``oa`` (complex64 (B, n, t)), or an :class:`OmegaKey`: the kernels then
draw the words of ``philox.omega_fields`` for each element in registers
(the megachain and mega engines), and the plain versions are
``philox.omega_fields`` followed by the stored-mode op. A key's iteration
may live on the device (a graph replay's counter, :mod:`graph`).

CPU tensors take the ``plain_*`` version beside each wrapper; it has the
wrapper's signature and runs on any device.
"""
from typing import NamedTuple, Union

import torch

from ..philox import MASK32, iteration, omega_fields, time_mask
from . import _build

F32, C64 = torch.float32, torch.complex64


class OmegaKey(NamedTuple):
    """The omegas of one iteration, by their streams: the fields
    ``philox.omega_fields(seed, sids, g + g_off, n, t, ntimes, nfreqs,
    row_times)`` of the draw's shapes and mask. ``g`` is an int, or a (1,)
    int32 tensor on the draw's device that the kernels read when they run
    (the first iteration of a chunk replayed as a CUDA graph)."""

    seed: int
    sids: torch.Tensor   # (B,) int32 row stream ids, on the draw's device
    g: Union[int, torch.Tensor]   # global iteration, or its device counter
    g_off: int = 0                # added to g


def _g_tensor(key):
    """The key's device counter, or None (for the device checks)."""
    return key.g if key is not None and torch.is_tensor(key.g) else None


def _check_row_times(row_times, B, dev):
    if row_times is not None:
        _build.check(row_times, "row_times", torch.int32, (B,), dev)


def _omegas(field, key, name):
    """Raise unless exactly one of the stored ``field`` and ``key`` is
    given."""
    if (field is None) == (key is None):
        raise ValueError(f"give either {name} or key")


def _key_args(key, B, dev):
    """``(seed, sids pointer, g, g_dev pointer)`` of the C entry; zeros for
    stored mode."""
    if key is None:
        return 0, None, 0, None
    _build.check(key.sids, "key.sids", torch.int32, (B,), dev)
    return (int(key.seed) & MASK32, _build.ptr(key.sids),
            *_build.iteration_args(key.g, key.g_off, dev))


def _plain_fields(key, shape, ntimes, nfreqs, row_times):
    _, n, t = shape
    return omega_fields(key.seed, key.sids, iteration(key.g, key.g_off), n,
                        t, ntimes, nfreqs, row_times)


# --- rc = ni_d + nih * omega_b * tmask -----------------------------------

def plain_draw_rhs(nid, nih, ob, ntimes, row_times=None, key=None):
    """Keyed: ``ob`` is ``omega_fields``' second field (it does not depend
    on ``nfreqs``)."""
    if key is not None:
        ob = _plain_fields(key, nid.shape, ntimes, 1, row_times)[1]
    return nid + nih[:, :, None] * (ob * time_mask(ob.shape[2], ntimes,
                                                   ob.device, row_times))


def draw_rhs(nid, nih, ob, ntimes: int, row_times=None, key=None):
    """``rc`` from the stored ``ob`` or, with ``ob=None``, the
    :class:`OmegaKey` ``key``."""
    _omegas(ob, key, "ob")
    if _build.on_cpu(nid, nih, ob, row_times,
                     None if key is None else key.sids, _g_tensor(key)):
        return plain_draw_rhs(nid, nih, ob, ntimes, row_times, key)
    B, n, t = nid.shape
    dev = nid.device
    _build.check(nid, "nid", C64, (B, n, t), dev)
    _build.check(nih, "nih", F32, (B, n), dev)
    if ob is not None:
        _build.check(ob, "ob", C64, (B, n, t), dev)
    _check_row_times(row_times, B, dev)
    seed, sids, g, g_dev = _key_args(key, B, dev)
    rc = torch.empty_like(nid)
    _build.call("draw_rhs", "hk_draw_rhs", _build.ptr(nid), _build.ptr(nih),
                _build.ptr(ob), seed, sids, g, g_dev, _build.ptr(rc), B, n,
                t, ntimes, _build.ptr(row_times))
    return rc


# --- system S = (dd dd^T P~ + I) dinv dinv^T, xs = dinv (dd frc + oa) -----

def plain_draw_system(pt, ps, frc, oa, ntimes, nfreqs, row_times=None,
                      key=None):
    if key is not None:
        oa = _plain_fields(key, frc.shape, ntimes, nfreqs, row_times)[0]
    n = pt.shape[1]
    tiny = torch.finfo(F32).tiny
    dd = torch.sqrt(torch.clamp(ps, min=0.0) / nfreqs)
    diag = torch.diagonal(pt, dim1=1, dim2=2).real
    dinv = torch.rsqrt(torch.clamp(1.0 + dd * dd * diag, min=tiny))
    outer = dd[:, :, None] * dd[:, None, :]
    dscale = dinv[:, :, None] * dinv[:, None, :]
    eye = torch.eye(n, dtype=F32, device=pt.device)
    s = torch.complex((outer * pt.real + eye) * dscale,
                      (outer * pt.imag) * dscale)
    tm = time_mask(frc.shape[2], ntimes, frc.device, row_times)
    xs = dinv[:, :, None] * (dd[:, :, None] * frc + oa * tm)
    return s, xs, dd, dinv


def draw_system(pt, ps, frc, oa, ntimes: int, nfreqs: int, row_times=None,
                key=None):
    """Returns ``(S, xs, dd, dinv)``; omegas from the stored ``oa`` or,
    with ``oa=None``, the :class:`OmegaKey` ``key``."""
    _omegas(oa, key, "oa")
    if _build.on_cpu(pt, ps, frc, oa, row_times,
                     None if key is None else key.sids, _g_tensor(key)):
        return plain_draw_system(pt, ps, frc, oa, ntimes, nfreqs, row_times,
                                 key)
    B, n, t = frc.shape
    dev = frc.device
    _build.check(pt, "pt", C64, (B, n, n), dev)
    _build.check(ps, "ps", F32, (B, n), dev)
    _build.check(frc, "frc", C64, (B, n, t), dev)
    if oa is not None:
        _build.check(oa, "oa", C64, (B, n, t), dev)
    _check_row_times(row_times, B, dev)
    seed, sids, g, g_dev = _key_args(key, B, dev)
    s = torch.empty_like(pt)
    xs = torch.empty_like(frc)
    dd = torch.empty_like(ps)
    dinv = torch.empty_like(ps)
    _build.call("draw_system", "hk_draw_system", _build.ptr(pt),
                _build.ptr(ps), _build.ptr(frc), _build.ptr(oa), seed, sids,
                g, g_dev, _build.ptr(s), _build.ptr(xs), _build.ptr(dd),
                _build.ptr(dinv), B, n, t, ntimes, nfreqs,
                _build.ptr(row_times))
    return s, xs, dd, dinv


# --- y = s2 (s1 x), sums = sum_t |y|^2 -----------------------------------

def plain_row_scale_sumsq(x, s1=None, s2=None, want_y: bool = True):
    y = x
    if s1 is not None:
        y = s1[:, :, None] * y
    if s2 is not None:
        y = s2[:, :, None] * y
    sums = torch.sum(y.real * y.real + y.imag * y.imag, dim=2)
    return (y if want_y else None), sums


def row_scale_sumsq(x, s1=None, s2=None, want_y: bool = True):
    """``(y, sums)``; ``y`` is None unless ``want_y``."""
    if _build.on_cpu(x, s1, s2):
        return plain_row_scale_sumsq(x, s1, s2, want_y)
    B, n, t = x.shape
    dev = x.device
    _build.check(x, "x", C64, (B, n, t), dev)
    for name, s in (("s1", s1), ("s2", s2)):
        if s is not None:
            _build.check(s, name, F32, (B, n), dev)
    y = torch.empty_like(x) if want_y else None
    sums = torch.empty((B, n), dtype=F32, device=dev)
    _build.call("row_scale_sumsq", "hk_row_scale_sumsq", _build.ptr(x),
                _build.ptr(s1), _build.ptr(s2), _build.ptr(y),
                _build.ptr(sums), B * n, t)
    return y, sums


# --- residual statistics and amplitudes ----------------------------------

def plain_draw_resid(dw, sig, fa, ninvf, w, da, a0, ntimes, *, want_chi,
                     want_chit, want_amp, want_ws, chi_out=None,
                     amp_out=None, row_times=None):
    res = dw - sig - fa
    res2 = res.real * res.real + res.imag * res.imag
    chi = res2 * ninvf[:, :, None]
    noise = torch.sum(res2 * (w * ninvf)[:, :, None], dim=2)
    chit = (torch.sum(chi * time_mask(dw.shape[2], ntimes, dw.device,
                                      row_times), dim=2)
            if want_chit else None)
    amp = da + a0 if want_amp else None
    ws = w[:, :, None] * sig if want_ws else None
    if want_chi and chi_out is not None:
        chi = chi_out.copy_(chi)
    if amp is not None and amp_out is not None:
        amp = amp_out.copy_(amp)
    return (chi if want_chi else None), noise, chit, amp, ws


def draw_resid(dw, sig, fa, ninvf, w, da, a0, ntimes: int, *,
               want_chi: bool, want_chit: bool, want_amp: bool,
               want_ws: bool, chi_out=None, amp_out=None, row_times=None):
    """``(chi, noise_nu, chi_t, amps, w*sig)``, the unwanted ones None.
    ``chi_out``/``amp_out``: optional preallocated outputs."""
    if _build.on_cpu(dw, sig, fa, ninvf, w, da, a0, row_times):
        return plain_draw_resid(dw, sig, fa, ninvf, w, da, a0, ntimes,
                                want_chi=want_chi, want_chit=want_chit,
                                want_amp=want_amp, want_ws=want_ws,
                                chi_out=chi_out, amp_out=amp_out,
                                row_times=row_times)
    B, n, t = dw.shape
    m = da.shape[1]
    dev = dw.device
    for name, v in (("dw", dw), ("sig", sig), ("fa", fa)):
        _build.check(v, name, C64, (B, n, t), dev)
    for name, v in (("ninvf", ninvf), ("w", w)):
        _build.check(v, name, F32, (B, n), dev)
    for name, v in (("da", da), ("a0", a0)):
        _build.check(v, name, C64, (B, m, t), dev)
    _check_row_times(row_times, B, dev)
    chi = None
    if want_chi:
        chi = chi_out if chi_out is not None else torch.empty(
            (B, n, t), dtype=F32, device=dev)
        _build.check(chi, "chi_out", F32, (B, n, t), dev)
    amp = None
    if want_amp:
        amp = amp_out if amp_out is not None else torch.empty_like(da)
        _build.check(amp, "amp_out", C64, (B, m, t), dev)
    noise = torch.empty((B, n), dtype=F32, device=dev)
    chit = torch.empty((B, n), dtype=F32, device=dev) if want_chit else None
    ws = torch.empty_like(sig) if want_ws else None
    _build.call("draw_resid", "hk_draw_resid", _build.ptr(dw),
                _build.ptr(sig), _build.ptr(fa), _build.ptr(ninvf),
                _build.ptr(w), _build.ptr(da), _build.ptr(a0),
                _build.ptr(chi), _build.ptr(noise), _build.ptr(chit),
                _build.ptr(amp), _build.ptr(ws), B, n, m, t, ntimes,
                _build.ptr(row_times))
    return chi, noise, chit, amp, ws
