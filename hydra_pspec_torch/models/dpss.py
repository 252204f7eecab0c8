"""DPSS (discrete prolate spheroidal sequence) foreground mode fitting
(port of ``hydra_pspec_tpu/models/dpss.py``, its complex tier).

The reference (hydra_pspec/dpss.py:7-94) fits ``nmodes`` DPSS basis
functions to masked complex data by L-BFGS-B on ``0.5 Re[x^H C^-1 x]``
over interleaved real and imaginary coefficients. The model is linear in
complex coefficients on real basis vectors, so the minimum is closed-form:
with ``Phi = (taper w)[:, None] basis`` and ``H`` the Hermitian part of
``C^-1``,

    (Phi^T H Phi) z = Phi^T H (taper w d).

The basis is a one-time eigenproblem, solved with scipy on the host; the
fit is library products and solves on ``device``, the card unless the
caller asks for the CPU: tensors passed in keep their device, and numpy
arrays and numbers go to the tensors' device, or to ``device`` when no
input is a tensor. The real-pair twin
``dpss_fit_modes_rp`` exists because the TPU has no complex dtype, so it
is not ported.
"""
import numpy as np
import torch

from ..ops.special import as_input, input_device

F64 = torch.float64


def dpss_basis(nfreqs: int, nmodes: int, alpha: float = 1.0) -> np.ndarray:
    """DPSS basis, (nmodes, nfreqs): ``scipy.signal.windows.dpss`` with
    ``NW=alpha, Kmax=nmodes, sym=False`` (reference dpss.py:69-72)."""
    from scipy.signal.windows import dpss as _dpss

    return np.ascontiguousarray(_dpss(nfreqs, NW=alpha, Kmax=nmodes,
                                      sym=False))


def dpss_operator(nfreqs: int, nmodes: int, alpha: float = 1.0) -> np.ndarray:
    """DPSS modes as a (nfreqs, nmodes) column basis: a drop-in for the
    CLI's ``fgmodes`` (run-hydra-pspec.py:440-460 uses PCA eigenvectors or
    Legendre polynomials)."""
    return dpss_basis(nfreqs, nmodes, alpha).T


def dpss_fit_modes(d, w, freqs, cov, nmodes=10, alpha=1.0, taper=None, *,
                   device="cuda"):
    """Closed-form GLS DPSS fit (reference dpss.py:7-94): ``(modes,
    amps)``, ``modes`` (nmodes, nfreqs) on ``d``'s device and ``amps`` the
    2 nmodes real coefficients, re and im interleaved (the reference's
    packing, dpss.py:80, 89)."""
    device = input_device(device, d, w, cov, taper)
    d = as_input(d, device)
    nfreqs = d.shape[-1]
    modes = torch.as_tensor(dpss_basis(nfreqs, nmodes, alpha),
                            device=d.device)
    w = as_input(w, device, F64)
    taper = (torch.ones(nfreqs, dtype=F64, device=d.device) if taper is None
             else as_input(taper, device, F64))
    invcov = torch.linalg.inv(as_input(cov, device))
    H = 0.5 * (invcov + invcov.mH)
    weight = taper * w
    phi = (weight[:, None] * modes.T).to(H.dtype)        # (nfreqs, nmodes)
    rhs = phi.mH @ (H @ (weight * d))
    z = torch.linalg.solve(phi.mH @ H @ phi, rhs)
    amps = torch.stack([z.real, z.imag], dim=-1).reshape(-1)
    return modes, amps


def dpss_model(modes, amps, *, device="cuda"):
    """The fitted foreground model from interleaved re / im coefficients
    (reference loglike model, dpss.py:80-81)."""
    device = input_device(device, modes, amps)
    amps, modes = as_input(amps, device), as_input(modes, device)
    z = amps[0::2] + 1.0j * amps[1::2]
    return (z[:, None] * modes).sum(dim=0)
