"""Hermitian factor + multi-right-hand-side solve: the port of the TPU
kernel ``ops/pallas/spd_solve.py::spd_factor_solve`` (``_spd_kernel``) and
of its wrapper ``hermitian_solve_pallas`` (:251-275), the real engine's
default solver on an accelerator.

Kernel: ``csrc/herm_chol_solve.cu``. The TPU factored the 2n x 2n real
embedding in blocks of 32 with 3-pass bf16 products, because it has no
complex ALU and Mosaic no f32 product. Here the n x n Hermitian matrix is
factored directly in FP32 complex arithmetic (half the memory, half the
real FMAs; no tensor cores, no TF32), in one launch: one CTA per chain
factors it on 32 x 32 tiles in shared memory (``csrc/herm_chol.cuh``),
folds the inverses of the diagonal tiles into the off-diagonal blocks, and
runs the forward and backward sweeps over all right-hand sides from there,
so L never goes to device memory. Above 128 (to 192) the CTA keeps only the
lower tiles (``csrc/herm_tri.cuh``) and sweeps in chunks of 16 columns, a
chunk on 4 warps that each hold 8 rows of every row block, so every warp
works at every sweep step. One call takes n <= :data:`BASE_N`, as for
``herm_inv``, and counts one ``herm_chol_solve`` launch. A larger n goes
through :func:`blocked_herm_chol_solve`, block elimination over such calls
with :mod:`cgemm` products.
"""
import torch

from . import _build
from .cgemm import cgemm

BASE_N = 192  # the factor holds the lower tiles in a block's shared memory


def plain_herm_chol_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The same function with ordinary torch ops, on any device: Cholesky
    and two triangular solves."""
    l, _ = torch.linalg.cholesky_ex(a)
    y = torch.linalg.solve_triangular(l, b, upper=False)
    return torch.linalg.solve_triangular(l.transpose(-2, -1).conj(), y,
                                         upper=True)


def split_at(n: int, base_n: int) -> int:
    """Where the block recursions split ``n > base_n``: at a multiple of
    ``base_n``, ``n1 = base_n ceil(ceil(n / base_n) / 2)``, so the leading
    block keeps the base kernel's best size."""
    p = -(-n // base_n)
    return base_n * -(-p // 2)


def blocked_herm_chol_solve(a: torch.Tensor, b: torch.Tensor, *, base, mm,
                            base_n: int = BASE_N) -> torch.Tensor:
    """``x = a^-1 b`` for Hermitian PD ``a`` (B, n, n) and ``b`` (B, n, K)
    by block elimination, split at :func:`split_at`:

        [Y | T] = A11^-1 [b1 | A12]   (one base call, side by side),
        S = A22 - A12^H T,  x2 = S^-1 (b2 - A12^H Y),  x1 = Y - T x2.

    The same function as one factor-solve, with its own rounding.
    ``base(a, b)`` solves systems of at most ``base_n``, ``mm`` is the
    ``cgemm`` contract; ``S`` is read through its lower triangle only, as
    the base's Cholesky does."""
    n, k = a.shape[-1], b.shape[-1]
    if n <= base_n:
        return base(a, b)
    n1 = split_at(n, base_n)
    rec = lambda m, r: blocked_herm_chol_solve(m, r, base=base, mm=mm,
                                               base_n=base_n)
    a12 = a[:, :n1, n1:].contiguous()
    yt = rec(a[:, :n1, :n1].contiguous(), torch.cat([b[:, :n1], a12], 2))
    y, t = yt[:, :, :k].contiguous(), yt[:, :, k:].contiguous()
    s = mm(a12, t, op="H", x=a[:, n1:, n1:].contiguous(), alpha=-1.0)
    x2 = rec(s, mm(a12, y, op="H", x=b[:, n1:].contiguous(), alpha=-1.0))
    return torch.cat([mm(t, x2, x=y, alpha=-1.0, out=y), x2], 1)


def herm_chol_solve(a: torch.Tensor, b: torch.Tensor,
                    base_n: int = BASE_N) -> torch.Tensor:
    """``x = a^-1 b`` for Hermitian PD complex64 ``a`` (B, n, n) and ``b``
    (B, n, K), without equilibration (see :func:`hermitian_solve_chol`),
    any n: one call of the kernel for n <= ``base_n``, else
    :func:`blocked_herm_chol_solve` over such calls and ``cgemm``
    products (each counted as its own launch). ``base_n`` (at most
    :data:`BASE_N`): 128 gives the blocked route that served
    128 < n <= 192 before the lower-tile kernel, kept to time against
    it."""
    if _build.on_cpu(a, b):
        return plain_herm_chol_solve(a, b)
    if a.dim() != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"herm_chol_solve takes (B, n, n); got "
                         f"{tuple(a.shape)}")
    if not 0 < base_n <= BASE_N:
        raise ValueError(f"herm_chol_solve: base_n {base_n} not in "
                         f"[1, {BASE_N}]")
    batch, n, _ = a.shape
    if n > base_n:
        return blocked_herm_chol_solve(a, b, base=herm_chol_solve, mm=cgemm,
                                       base_n=base_n)
    _build.check(a, "a", torch.complex64)
    _build.check(b, "b", torch.complex64, (batch, n, None), a.device)
    x = torch.empty_like(b)
    # the C interface's L scratch is unused: L stays in shared memory
    _build.call("herm_chol_solve", "hk_herm_chol_solve", _build.ptr(a),
                _build.ptr(b), None, _build.ptr(x), batch, n, b.shape[2])
    return x


def equilibrate(m: torch.Tensor, jitter: float = 0.0):
    """Jacobi equilibration of Hermitian ``m`` (B, n, n): ``(D m D + jitter
    I, D)`` with ``D = diag(m)^-1/2`` (pivots clamped at the float32 tiny),
    as ``hermitian_solve_pallas`` does before its solve."""
    tiny = torch.finfo(torch.float32).tiny
    dinv = 1.0 / torch.sqrt(torch.clamp(
        torch.diagonal(m, dim1=-2, dim2=-1).real, min=tiny))
    ms = m * (dinv[..., :, None] * dinv[..., None, :])
    if jitter:
        ms = ms + jitter * torch.eye(m.shape[-1], dtype=m.dtype,
                                     device=m.device)
    return ms.contiguous(), dinv


def hermitian_solve_chol(m: torch.Tensor, b: torch.Tensor,
                         jitter: float = 0.0, solve=herm_chol_solve):
    """Jacobi-equilibrated solve of ``m x = b`` for Hermitian PD ``m``
    (B, n, n) and ``b`` (B, n, K), ``jitter`` added to the equilibrated
    diagonal: the counterpart of ``hermitian_solve_pallas``. ``solve``:
    the factor-solve to use (the kernel by default; the real engine's
    ``solver="chol"`` passes :func:`plain_herm_chol_solve`)."""
    ms, dinv = equilibrate(m, jitter)
    x = solve(ms, (b * dinv[..., :, None]).contiguous())
    return x * dinv[..., :, None]
