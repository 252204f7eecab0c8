"""Optimal Quadratic Estimator (OQE) of the delay power spectrum (port of
``hydra_pspec_tpu/models/oqe.py``, its complex tier).

The reference (hydra_pspec/oqe.py) builds rank-1 delay operators
``Q(tau) = conj(m) m^T`` with ``m = fft(delta_tau)`` (oqe.py:7-20),
estimator values ``qhat = 0.5 x^H Rbar Q R x - bias`` (oqe.py:27-40), a
Fisher matrix of O(s^2) traces (oqe.py:43-66), normalisations
(oqe.py:69-84) and error bars (oqe.py:161-185). No ``Q`` matrix is formed
here: ``m_tau[k] = exp(-2 pi i k tau / s)`` is a DFT row, so

  * ``x^H Rbar Q_t R x = conj(fft(R^T x)[t]) fft(R x)[t]``;
  * ``(R x1)^H Q_t (R x2) = conj(fft(R x1)[t]) fft(R x2)[t]``;
  * ``tr(A Q_t)`` terms are diagonals of ``F A F^H``, two FFT passes;
  * the Fisher matrix is ``F[a, b] = 0.5 G1[a, b] G2[b, a]`` with
    ``G1 = F R F^H`` and ``G2 = F conj(R) F^H``.

Plain functions on complex128 tensors; the FFTs, products and inverses
are library calls (the JAX package computes them outside any Pallas
kernel). Each takes ``device``, the card unless the caller asks for the
CPU: tensors passed in keep their device, and numpy arrays and numbers go
to the tensors' device, or to ``device`` when no input is a tensor. The
real-pair ``*_rp`` twins exist because the TPU has no complex dtype, so
they are not ported.
"""
import math

import torch

from ..ops.linalg import hermitian_sqrt
from ..ops.special import as_input, input_device


def _c(x, device):
    """``x`` as a complex128 tensor (:func:`as_input`)."""
    return as_input(x, device, torch.complex128)


def m(tau, s, *, device="cuda"):
    """DFT row ``m_tau = fft(delta_tau)`` (reference oqe.py:7-10)."""
    k = torch.arange(s, dtype=torch.float64, device=device)
    return torch.exp(-2.0j * math.pi * k * tau / s)


def Q(tau, s, *, device="cuda"):
    """Rank-1 delay operator ``outer(conj(m), m)`` (reference oqe.py:13-20,
    without its disk cache)."""
    mt = m(tau, s, device=device)
    return torch.outer(mt.conj(), mt)


def _dft2(a):
    """``G[t, u] = sum_jk exp(-2 pi i t j / s) a[j, k] exp(2 pi i u k / s)``
    = ``F a F^H`` for the unnormalised DFT matrix F."""
    s = a.shape[-1]
    return torch.fft.ifft(torch.fft.fft(a, dim=-2), dim=-1) * s


def _diag_dft2(a):
    """Diagonal of ``F a F^H``: the vector ``m_t^T a conj(m_t)``."""
    return torch.diagonal(_dft2(a), dim1=-2, dim2=-1)


def bias(R, C_noise_total, *, device="cuda"):
    """The bias ``0.5 tr(C Rbar Q_t R)`` of every tau (reference
    oqe.py:23-24, one tau at a time)."""
    device = input_device(device, R, C_noise_total)
    R = _c(R, device)
    return 0.5 * _diag_dft2(R @ _c(C_noise_total, device) @ R.conj())


def qhat_all(x, R, bias_vec=None, *, device="cuda"):
    """``0.5 x^H (Rbar Q_t R) x - bias`` for every tau (reference
    oqe.py:27-30, per tau). ``x``: (..., s)."""
    device = input_device(device, x, R, bias_vec)
    R, x = _c(R, device), _c(x, device)
    rx = torch.fft.fft(x @ R.T, dim=-1)
    rtx = torch.fft.fft(x @ R, dim=-1)
    q = 0.5 * rtx.conj() * rx
    if bias_vec is not None:
        q = q - _c(bias_vec, device)
    return q


def qhat_h_all(x1, x2, R, *, device="cuda"):
    """The HERA-style cross term ``0.5 (R x1)^H Q_t (R x2)`` for every tau
    (reference oqe.py:33-40, per tau). Inputs (..., s)."""
    device = input_device(device, x1, x2, R)
    R = _c(R, device)
    f1 = torch.fft.fft(_c(x1, device) @ R.T, dim=-1)
    f2 = torch.fft.fft(_c(x2, device) @ R.T, dim=-1)
    return 0.5 * f1.conj() * f2


def qhat(x, tau, s, R, bias_scalar=0.0, *, device="cuda"):
    """One tau of :func:`qhat_all` (reference oqe.py:27-30)."""
    return qhat_all(x, R, device=device)[..., tau] - bias_scalar


def qhat_h(x1, x2, tau, s, R, *, device="cuda"):
    """One tau of :func:`qhat_h_all` (reference oqe.py:33-40)."""
    return qhat_h_all(x1, x2, R, device=device)[..., tau]


def F(R, *, device="cuda"):
    """Fisher matrix ``F[a, b] = 0.5 tr(Rbar Q_a R Q_b)`` (reference
    oqe.py:43-66) as two 2D DFTs."""
    R = _c(R, input_device(device, R))
    return 0.5 * _dft2(R) * _dft2(R.conj()).T


def M_Finv(Fm, *, device="cuda"):
    """Normalisation ``M = F^-1`` (reference oqe.py:73-74)."""
    return torch.linalg.inv(_c(Fm, input_device(device, Fm)))


def M_Fhalf(Fm, *, device="cuda"):
    """``M = F^-1/2`` by the Hermitian square root of F's Hermitian part
    (reference oqe.py:69-70, broken as shipped: no ``sp`` import)."""
    Fm = _c(Fm, input_device(device, Fm))
    return torch.linalg.inv(hermitian_sqrt(0.5 * (Fm + Fm.mH)))


def M_opt(Fm, *, device="cuda"):
    """Window-normalised diagonal M (reference oqe.py:77-84)."""
    Fm = _c(Fm, input_device(device, Fm))
    Md = torch.diag(1.0 / torch.diagonal(Fm))
    W = Md @ Fm
    return Md / W.sum(dim=1, keepdim=True)


def p(q, M, *, device="cuda"):
    """Normalised bandpowers (reference oqe.py:117-118)."""
    device = input_device(device, q, M)
    return as_input(M, device) @ as_input(q, device)


def q(V, s, R, bias_vec, *, device="cuda"):
    """The auto-correlation estimator over visibilities (reference
    oqe.py:88-101, which stores complex values into a real array: the real
    part is kept here explicitly)."""
    return qhat_all(V, R, bias_vec, device=device).real


def q_h(V, s, R, taper=None, *, device="cuda"):
    """The cross-correlation estimator over adjacent visibility pairs
    (reference oqe.py:104-114)."""
    V = _c(V, input_device(device, V, R))
    return qhat_h_all(V[0::2], V[1::2], R, device=device)


def q_hp(V, s, R, ncpu=None, *, device="cuda"):
    """The reference's process-pool variant (oqe.py:147-158): the batched
    FFT form needs no pool; ``ncpu`` is accepted for the API."""
    return q_h(V, s, R, device=device)


def matc(M, *, device="cuda"):
    """Condition diagnostics (reference oqe.py:121-127), returned instead
    of printed: (positive definite, eigenvalue ratio, norm condition)."""
    M = _c(M, input_device(device, M))
    evs = torch.linalg.eigvals(M).real
    return (bool(torch.all(evs > 0)),
            float(evs.max() / evs.min()),
            float(torch.linalg.norm(M) * torch.linalg.norm(
                torch.linalg.inv(M))))


def getqs(Vis, R, verbose=False, *, device="cuda"):
    """The end-to-end OQE skeleton (reference oqe.py:130-144, broken as
    shipped: no ``time`` import): condition diagnostics, Fisher matrix,
    normalisations and the pairs' cross terms; ``(qs, F, M_opt, M_Finv)``."""
    device = input_device(device, Vis, R)
    Vis, R = _c(Vis, device), _c(R, device)
    s = Vis.shape[-1]
    if verbose:
        pd, ratio, cond = matc(R)
        print(f"{pd} - positive definite; eig ratio {ratio:.3e}; "
              f"cond {cond:.3f}")
    Fm = F(R)
    return q_h(Vis, s, R), Fm, M_opt(Fm), M_Finv(Fm)


def Sig_QEN(R, C_noise, norm, *, device="cuda"):
    """Noise-only error bar ``0.5 tr(E C E C)``, ``E = R Q_t R norm``
    (reference oqe.py:161-173), by the rank-1 form
    ``tr(u v^T C u v^T C) = (v^T C u)^2``. ``norm``: a scalar or one per
    tau."""
    device = input_device(device, R, C_noise, norm)
    R = _c(R, device)
    t = _diag_dft2(R @ _c(C_noise, device) @ R)
    return 0.5 * (_c(norm, device) * t) ** 2


def Sig_QESN(R, C_noise, C_S, norm, *, device="cuda"):
    """Signal-plus-noise error bar (reference oqe.py:177-185)."""
    device = input_device(device, R, C_noise, C_S, norm)
    R = _c(R, device)
    tn = _diag_dft2(R @ _c(C_noise, device) @ R)
    ts = _diag_dft2(R @ _c(C_S, device) @ R)
    return 0.5 * _c(norm, device) ** 2 * (tn * tn + 2.0 * ts * tn)
