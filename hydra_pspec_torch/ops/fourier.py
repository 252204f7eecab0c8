"""Centered DFT operator (port of ``hydra_pspec_tpu/ops/cplx.py:127-131``
and ``ops/fourier.py``): the float32 engines' host matrix
(:func:`dft_matrix`) and the complex float64 engine's torch operators.

``F[k, x] = exp(-2 pi i k x / n)`` with both indices offset by ``n // 2``;
multiplying by ``F`` equals ``fftshift(fft(ifftshift(x)))``. ``F`` is
complex-symmetric and ``F F^H = n I``.
"""
import numpy as np
import torch


def dft_matrix(n: int, dtype=np.float32) -> np.ndarray:
    """Centered DFT matrix as complex numpy at ``dtype`` precision. The
    cosine and sine are taken in float64 and rounded part by part, as the
    JAX package does, so the two builds agree bit for bit."""
    i = np.arange(n) - n // 2
    ph = np.outer(i, i) * (-2.0 * np.pi / n)
    return (np.cos(ph) + 1j * np.sin(ph)).astype(
        np.result_type(dtype, np.complex64))


# --- the complex float64 engine's operators (``ops/fourier.py:20-76``) -----

def fourier_operator(n: int, dtype=torch.complex128, device="cuda"):
    """The centred DFT matrix ``F[k, x] = exp(-2 pi i k x / n)`` as a torch
    tensor on ``device`` (the card unless the caller asks for the CPU;
    ``ops/fourier.py:20-37``): built on the host in float64, then cast.
    ``F F^H = n I``, ``F^T = F``."""
    i = np.arange(n) - n // 2
    op = np.exp(1j * (np.outer(i, i) * (-2.0 * np.pi / n)))
    return torch.as_tensor(op).to(dtype=dtype, device=device)


def cfft(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Centred FFT ``fftshift(fft(ifftshift(x)))`` along ``dim``: the same
    as left-multiplying by :func:`fourier_operator` (``:40-49``)."""
    x = torch.fft.ifftshift(x, dim=dim)
    return torch.fft.fftshift(torch.fft.fft(x, dim=dim), dim=dim)


def icfft(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inverse of :func:`cfft`."""
    x = torch.fft.ifftshift(x, dim=dim)
    return torch.fft.fftshift(torch.fft.ifft(x, dim=dim), dim=dim)


def covariance_from_pspec(ps: torch.Tensor, fourier_op: torch.Tensor):
    """``C = F^H diag(ps) F`` from bandpowers ``ps`` (..., n) (``:59-65``);
    ``ps`` carries the caller's FFT normalisation."""
    ps = ps.to(fourier_op.dtype)
    return (fourier_op.conj().mT * ps[..., None, :]) @ fourier_op


def pspec_from_covariance(C: torch.Tensor, fourier_op: torch.Tensor):
    """Delay-diagonal bandpowers ``diag(F C F^H) / n^2`` of a covariance
    (``:68-76``): the inverse of :func:`covariance_from_pspec` for a
    delay-diagonal ``C``."""
    n = C.shape[-1]
    diag = torch.einsum("ki,...ij,kj->...k", fourier_op, C.to(
        fourier_op.dtype), fourier_op.conj())
    return diag.real / n**2
