"""Centered DFT operator (port of ``hydra_pspec_tpu/ops/cplx.py:127-131``
and ``ops/fourier.py``).

``F[k, x] = exp(-2 pi i k x / n)`` with both indices offset by ``n // 2``;
multiplying by ``F`` equals ``fftshift(fft(ifftshift(x)))``. ``F`` is
complex-symmetric and ``F F^H = n I``.
"""
import numpy as np


def dft_matrix(n: int, dtype=np.float32) -> np.ndarray:
    """Centered DFT matrix as complex numpy at ``dtype`` precision. The
    cosine and sine are taken in float64 and rounded part by part, as the
    JAX package does, so the two builds agree bit for bit."""
    i = np.arange(n) - n // 2
    ph = np.outer(i, i) * (-2.0 * np.pi / n)
    return (np.cos(ph) + 1j * np.sin(ph)).astype(
        np.result_type(dtype, np.complex64))
