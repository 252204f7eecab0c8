"""Masked-noise operators and the Hermitian Cholesky solve of the complex
float64 engine (port of ``hydra_pspec_tpu/ops/linalg.py:24-105``).

``Ni = (w w^T) o Ninv`` is a vector for diagonal noise (every shipped
configuration) and a dense Hermitian matrix otherwise, with its square
root ``Nih`` by ``eigh``, built once per chain. Every function takes
optional leading batch axes: the engine stacks (baseline x chain) on one.
"""
from typing import NamedTuple, Optional

import torch


class NoiseOperators(NamedTuple):
    """Per-chain constants from (flags, Ninv): the masked inverse noise and
    its square root (``ni_diag``/``nih_diag``, or ``ni_dense``/
    ``nih_dense`` on the dense path) and the unmasked diagonal of Ninv
    that the chi^2 diagnostic reads (reference pspec.py:452)."""

    ni_diag: torch.Tensor
    nih_diag: torch.Tensor
    ninv_full_diag: torch.Tensor
    ni_dense: Optional[torch.Tensor] = None
    nih_dense: Optional[torch.Tensor] = None

    @property
    def is_diagonal(self) -> bool:
        return self.ni_dense is None

    def apply_ni(self, x: torch.Tensor) -> torch.Tensor:
        """``Ni @ x`` for x of shape (..., Nfreqs) (rows are vectors)."""
        if self.is_diagonal:
            return x * self.ni_diag[..., None, :]
        return x @ self.ni_dense.mT.to(x.dtype)

    def apply_nih(self, x: torch.Tensor) -> torch.Tensor:
        """``Nih @ x`` for x of shape (..., Nfreqs)."""
        if self.is_diagonal:
            return x * self.nih_diag[..., None, :]
        return x @ self.nih_dense.mT.to(x.dtype)


def hermitian_sqrt(m: torch.Tensor) -> torch.Tensor:
    """PSD square root of a Hermitian matrix by eigendecomposition (equals
    ``scipy.linalg.sqrtm`` on Hermitian PSD input, reference pspec.py:362)."""
    vals, vecs = torch.linalg.eigh(m)
    vals = torch.clamp(vals, min=0.0)
    return (vecs * torch.sqrt(vals)[..., None, :].to(vecs.dtype)) @ vecs.mH


def make_noise_operators(w: torch.Tensor, ninv) -> NoiseOperators:
    """Noise operators from flags ``w`` (1 = keep) and the inverse noise
    variance ``ninv``: a scalar, an (Nfreqs,) vector or an (Nfreqs, Nfreqs)
    matrix; a matrix with a non-zero off-diagonal entry takes the dense
    path."""
    ninv = torch.as_tensor(ninv)
    w = torch.as_tensor(w)
    wr = w.to(torch.promote_types(ninv.real.dtype, w.dtype))
    if ninv.ndim <= 1:
        diag_full = torch.broadcast_to(ninv.real, w.shape).to(wr.dtype)
        ni = wr * diag_full * wr
        return NoiseOperators(ni, torch.sqrt(ni), diag_full)
    diag_full = torch.diagonal(ninv).real
    offdiag = ninv - torch.diag_embed(torch.diagonal(ninv))
    if bool(torch.any(offdiag.abs() > 0)):
        ni = (wr[:, None] * ninv) * wr[None, :]
        nih = hermitian_sqrt(ni)
        ni_vec = torch.diagonal(ni).real
        return NoiseOperators(ni_vec, torch.sqrt(ni_vec), diag_full, ni, nih)
    ni = wr * diag_full * wr
    return NoiseOperators(ni, torch.sqrt(ni), diag_full)


def cholesky_solve(m: torch.Tensor, b: torch.Tensor, jitter: float = 0.0):
    """Solve the Hermitian positive-definite systems ``m x = b``, ``m``
    (..., n, n), ``b`` (..., n, k), by Cholesky and two triangular solves;
    ``jitter`` adds ``jitter * mean(diag)`` to the diagonal.

    Returns ``(x, info)``: ``info`` is ``cholesky_ex``'s (..., ) int32,
    non-zero where a factor failed. ``cholesky_ex`` leaves it on the
    device instead of reading it back (``cholesky`` synchronises the host
    to check it), so a caller checks it once per chunk; the JAX function
    returns ``x`` alone, NaN where its factor failed."""
    n = m.shape[-1]
    if jitter:
        scale = torch.mean(torch.diagonal(m, dim1=-2, dim2=-1).real, dim=-1)
        m = m + (jitter * scale)[..., None, None] * torch.eye(
            n, dtype=m.dtype, device=m.device)
    chol, info = torch.linalg.cholesky_ex(m)
    y = torch.linalg.solve_triangular(chol, b, upper=False)
    return torch.linalg.solve_triangular(chol.mH, y, upper=True), info
