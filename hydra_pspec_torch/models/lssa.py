"""Least-Squares Spectral Analysis (LSSA) estimator (port of
``hydra_pspec_tpu/models/lssa.py``, its complex tier).

The reference (hydra_pspec/lssa.py) fits one complex sinusoid per delay to
flag-trimmed data by L-BFGS-B on ``0.5 Re[x^H C^-1 x]`` (lssa.py:192-207),
then decorrelates the real and imaginary amplitudes with a 2 x 2 rotation
(lssa.py:14-92). The fit is linear in ``z = A_re + i A_im``, so its
minimum is closed-form, every tau in one batch:

    z*(tau) = (g^H H d) / (g^H H g),   g = taper exp(-2 pi i tau nu),
    H = (C^-1 + C^-H) / 2.

Plain functions on complex128 / float64 tensors (library products and
transcendentals; the JAX package runs them outside any Pallas kernel).
Each takes ``device``, the card unless the caller asks for the CPU:
tensors passed in keep their device, and numpy arrays and numbers go to
the tensors' device, or to ``device`` when no input is a tensor. The
real-pair twin ``lssa_fit_modes_rp`` exists because the TPU has no
complex dtype, so it is not ported.
"""
import math

import torch

from ..ops.special import as_input, input_device

F64 = torch.float64


def model_ap(amp, phase, tau, freqs, *, device="cuda"):
    """Sinusoid model, amplitude / phase form (reference lssa.py:6-7)."""
    xs = (amp, phase, tau, freqs)
    device = input_device(device, *xs)
    amp, phase, tau, freqs = (as_input(x, device, F64) for x in xs)
    return amp * torch.exp(-2.0j * math.pi * tau * freqs + 1.0j * phase)


def model_aa(A_re, A_im, tau, freqs, *, device="cuda"):
    """Sinusoid model, re / im amplitude form (reference lssa.py:10-11)."""
    xs = (A_re, A_im, tau, freqs)
    device = input_device(device, *xs)
    A_re, A_im, tau, freqs = (as_input(x, device, F64) for x in xs)
    return (A_re + 1.0j * A_im) * torch.exp(-2.0j * math.pi * tau * freqs)


def default_tau(freqs, *, device="cuda"):
    """Delay grid in nanoseconds, ``fftfreq(n, d=dfreq_MHz) * 1e3``
    (reference lssa.py:160), float64."""
    freqs = as_input(freqs, input_device(device, freqs), F64)
    return torch.fft.fftfreq(freqs.numel(), d=float(freqs[1] - freqs[0]),
                             dtype=F64, device=freqs.device) * 1e3


def lssa_fit_modes(d, freqs, invcov=None, fit_amp_phase=True, tau=None,
                   taper=None, *, device="cuda"):
    """Weighted LSSA fit to masked complex 1D data ``d`` (flagged channels
    removed); returns ``(tau, amp, phase)`` or ``(tau, A_re, A_im)``
    (reference lssa.py:95-208). The model phase keeps the reference's raw
    MHz / ns unit mix, ``exp(-2 pi i tau_ns freq_MHz)`` (lssa.py:7, 160)."""
    device = input_device(device, d, freqs, invcov, tau, taper)
    d = as_input(d, device)
    freqs = as_input(freqs, device, F64)
    tau = (default_tau(freqs) if tau is None
           else as_input(tau, device, F64))
    invcov = (torch.eye(d.numel(), dtype=d.dtype, device=d.device)
              if invcov is None else as_input(invcov, device))
    taper = (torch.ones_like(freqs) if taper is None
             else as_input(taper, device, F64))
    H = 0.5 * (invcov + invcov.mH)
    g = taper * torch.exp(-2.0j * math.pi * tau[:, None] * freqs)  # (T, n)
    hd = H @ (taper * d)
    num = g.conj() @ hd                                   # g^H H d
    den = ((g.conj() @ H) * g).sum(-1).real               # g^H H g
    z = num / torch.clamp(den, min=torch.finfo(den.dtype).tiny)
    if fit_amp_phase:
        return tau, z.abs(), torch.remainder(z.angle(), 2.0 * math.pi)
    return tau, z.real, z.imag


def decorr_matrix(w, tau, freqs, *, device="cuda"):
    """2 x 2 rotation decorrelating the masked cos / sin overlap for one
    tau (Eq. 8 of "Bryna's note", reference lssa.py:14-69): ``(rot,
    eigvals)``."""
    device = input_device(device, w, tau, freqs)
    w, tau, freqs = (as_input(x, device, F64) for x in (w, tau, freqs))
    c = w * torch.cos(2.0 * math.pi * tau[..., None] * freqs)
    s = w * torch.sin(2.0 * math.pi * tau[..., None] * freqs)
    cc, ss, cs = (c * c).sum(-1), (s * s).sum(-1), (c * s).sum(-1)
    theta = 0.5 * torch.atan2(2.0 * cs, cc - ss)
    ct, st = torch.cos(theta), torch.sin(theta)
    rot = torch.stack([torch.stack([ct, st], -1),
                       torch.stack([-st, ct], -1)], -2)
    cov = torch.stack([torch.stack([cc, cs], -1),
                       torch.stack([cs, ss], -1)], -2)
    eigvals = torch.diagonal(rot @ cov @ rot.mT, dim1=-2, dim2=-1)
    return rot, eigvals


def decorr_pspec(A_re, A_im, w, tau, freqs, *, device="cuda"):
    """LSSA power spectrum with the decorrelation re-weighting (reference
    lssa.py:73-92), every tau at once."""
    device = input_device(device, A_re, A_im, w, tau, freqs)
    rot, ev = decorr_matrix(w, tau, freqs, device=device)
    a = rot @ torch.stack([as_input(A_re, device, F64),
                           as_input(A_im, device, F64)], -1)[..., None]
    a1, a2 = a[..., 0, 0], a[..., 1, 0]
    return (((a1 * ev[..., 1]) ** 2 + (a2 * ev[..., 0]) ** 2)
            / (ev[..., 0] ** 2 + ev[..., 1] ** 2))
