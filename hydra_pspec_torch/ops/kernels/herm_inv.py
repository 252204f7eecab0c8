"""Per-chain inverse of a Hermitian positive-definite complex64 matrix,
and the equilibrated, refined Hermitian solve built on it.

Kernel: ``csrc/herm_inv.cu``. It replaces the recursive Schur inverse
``ops/pallas/spd_inv.py::_spd_inv_into`` and its 32x32 helpers
(``spd_solve.py::_chol_block``, ``_inv_lower_block``), which worked on the
2n x 2n real embedding because the TPU has no complex ALU. Here the n x n
Hermitian matrix is factored directly: one CTA per chain keeps the whole
matrix (132 KB at n = 128) in shared memory and runs, on 32 x 32 tiles,
the blocked Cholesky of ``csrc/herm_chol.cuh``, ``L^-1`` (diagonal tiles
inverted in parallel, the rest as tile products) and ``L^-H L^-1`` over
the lower tiles only. Above 128 (to 192) the CTA keeps only the lower
tiles (``csrc/herm_tri.cuh``, 177 KB at n = 192) and runs the same three
phases in place on them, as LAPACK's ``potri`` does. It is bound by the
factor's chain of single-warp steps and by the shared-memory bandwidth of
the tile products, not by HBM.

One launch takes n <= :data:`BASE_N`. A larger n goes through
:func:`blocked_herm_inv`, the 2 x 2 block Schur recursion of
``_spd_inv_into`` lifted to the complex Hermitian case, whose base case is
that kernel on blocks of at most 192 and whose products are :mod:`cgemm`.

The apply step ``x = A^-1 b`` and the refinement ``x += A^-1 (b - E x)``
(``megastep.py:176-196``) run through :mod:`cgemm`.

``active`` (int32 per chain) restricts the inverse to the flagged chains.
Up to 192 the other chains' CTAs return at once and their ``out`` is left
as it was; above, the blocked inverse runs its launches on the flagged
chains and per-chain selects write its quadrants into ``out``.

``gate`` takes the place of ``active`` for the megachain warm start: the
flags are its drift gate (``ops/pallas/megachain.py:366-379``), which each
chain's CTA computes from the chain's bandpowers before its first load and
writes to ``rebuild``, so the gate costs no launch of its own. Above 192
the first base launch computes them and every later launch and product of
the blocked inverse reads them as ``active``. The plain version is
:func:`plain_warm_gate` followed by the masked :func:`plain_herm_inv`.
"""
import functools

import torch

from . import _build
from .cgemm import cgemm
from .spd_solve import equilibrate, split_at

BASE_N = 192  # one launch holds the lower tiles in a block's shared memory


def _select(active, inv, out):
    """``out`` with the chains flagged in ``active`` replaced by ``inv``."""
    return out.copy_(torch.where(active[:, None, None] != 0, inv, out))


def plain_warm_gate(ps, psx, drift_max: float):
    """int32 (B,): 1 where chain b rebuilds its inverse, unless its largest
    relative bandpower move from ``psx`` to ``ps`` (B, m) is provably at
    most ``drift_max`` (a NaN rebuilds: ``NaN <= x`` is False)."""
    tiny = torch.finfo(torch.float32).tiny
    rel = torch.abs(ps - psx) / (
        0.5 * (torch.abs(ps) + torch.abs(psx))
        + 1e-6 * torch.amax(psx, dim=1, keepdim=True) + tiny)
    drift = torch.amax(rel, dim=1)
    return torch.logical_not(drift <= drift_max).to(torch.int32)


def plain_herm_inv(s: torch.Tensor, out=None, active=None, gate=None,
                   rebuild=None) -> torch.Tensor:
    """The same function with ordinary torch ops, on any device: Cholesky,
    triangular inverse, ``L^-H L^-1``; with ``gate``, the flags of
    :func:`plain_warm_gate` as ``active``."""
    if gate is not None:
        active = plain_warm_gate(*gate)
        if rebuild is not None:
            rebuild.copy_(active)
    l, _ = torch.linalg.cholesky_ex(s)
    eye = torch.eye(s.shape[-1], dtype=s.dtype, device=s.device)
    x = torch.linalg.solve_triangular(l, eye.expand_as(s), upper=False)
    inv = torch.matmul(x.transpose(-2, -1).conj(), x)
    if out is None:
        return inv
    if active is not None:
        return _select(active, inv, out)
    out.copy_(inv)
    return out


def blocked_herm_inv(s: torch.Tensor, *, base, mm, base_n: int = BASE_N,
                     out=None, active=None, gate=None, rebuild=None):
    """Inverse of each (n, n) Hermitian PD matrix of ``s`` (B, n, n) by the
    2 x 2 block Schur recursion of ``ops/pallas/spd_inv.py::_spd_inv_into``
    (:57-99) in complex Hermitian form, split at :func:`split_at`:

        T = A11^-1 A12,  S = A22 - A12^H T,  TS = T S^-1,
        A^-1 = [[A11^-1 + TS T^H, -TS], [-TS^H, S^-1]].

    ``base(s)`` inverts blocks of at most ``base_n``, ``mm`` is the
    :func:`cgemm` contract. The blocks are copied contiguous, and ``T^H``
    too (``mm`` has no op on B). Both bases read only the lower triangle
    of the Schur complement (their Cholesky), so its rounding away from
    Hermitian symmetry is never seen. ``out``/``active``/``gate``/
    ``rebuild``: as :func:`herm_inv`, each quadrant written into ``out``
    by a per-chain select (``base`` and ``mm`` may themselves skip the
    other chains). With ``gate`` the first ``base`` call (the top-left
    leaf) gets ``herm_inv``'s positional arguments ``(block, None, None,
    gate, rebuild)`` and writes the flags, which then select."""
    n = s.shape[-1]
    if gate is not None:
        if rebuild is None:
            rebuild = torch.empty((s.shape[0],), dtype=torch.int32,
                                  device=s.device)
        first = iter([(None, None, gate, rebuild)])
        base0, active = base, rebuild
        base = lambda m: base0(m, *next(first, ()))
    if n <= base_n:
        inv = base(s)
        if out is None:
            return inv
        return out.copy_(inv) if active is None else _select(active, inv, out)
    n1 = split_at(n, base_n)
    rec = lambda m: blocked_herm_inv(m, base=base, mm=mm, base_n=base_n)
    a12 = s[:, :n1, n1:].contiguous()
    inv11 = rec(s[:, :n1, :n1].contiguous())
    t = mm(inv11, a12)
    sinv = rec(mm(a12, t, op="H", x=s[:, n1:, n1:].contiguous(),
                  alpha=-1.0))
    ts = mm(t, sinv)
    mm(ts, t.transpose(-2, -1).conj().contiguous(), x=inv11, out=inv11)
    if out is None:
        out = torch.empty_like(s)
    keep = None if active is None else active[:, None, None] == 0
    top, bottom = slice(None, n1), slice(n1, None)
    for rows, cols, block in ((top, top, inv11), (top, bottom, -ts),
                              (bottom, top, -ts.transpose(-2, -1).conj()),
                              (bottom, bottom, sinv)):
        quad = out[:, rows, cols]
        if keep is None:
            quad.copy_(block)
        else:
            torch.where(keep, quad, block, out=quad)
    return out


def herm_inv(s: torch.Tensor, out=None, active=None, gate=None,
             rebuild=None, base_n: int = BASE_N) -> torch.Tensor:
    """Inverse of each (n, n) Hermitian PD matrix of ``s`` (B, n, n), any
    n: one kernel launch for n <= ``base_n``, else
    :func:`blocked_herm_inv` over such launches and :func:`cgemm` products
    (each counted as its own launch). ``active`` (optional int32 (B,)):
    only the flagged chains are inverted into ``out``; the others keep
    their ``out``. ``gate`` (optional, not with ``active``): ``(ps, psx,
    drift_max)``, ``ps`` and ``psx`` float32 (B, m): the flags are the
    warm start's drift gate computed in the launch (module docstring),
    written to ``rebuild`` (int32 (B,), allocated when not given).
    ``base_n`` (at most :data:`BASE_N`): 128 gives the blocked route that
    served 128 < n <= 192 before the lower-tile kernel, kept to time
    against it."""
    if gate is not None and active is not None:
        raise ValueError("herm_inv takes active or gate, not both")
    if _build.on_cpu(s, out, active, *(gate or ())[:2], rebuild):
        return plain_herm_inv(s, out, active, gate, rebuild)
    if s.dim() != 3 or s.shape[1] != s.shape[2]:
        raise ValueError(f"herm_inv takes (B, n, n); got {tuple(s.shape)}")
    if out is not None:
        _build.check(out, "out", torch.complex64, tuple(s.shape), s.device)
    batch, n, _ = s.shape
    if active is not None:
        _build.check(active, "active", torch.int32, (batch,), s.device)
    ps = psx = None
    drift_max, m = 0.0, 0
    if gate is not None:
        ps, psx, drift_max = gate
        _build.check(ps, "ps", torch.float32, (batch, None), s.device)
        m = ps.shape[1]
        _build.check(psx, "psx", torch.float32, (batch, m), s.device)
        if rebuild is None:
            rebuild = torch.empty((batch,), dtype=torch.int32,
                                  device=s.device)
        _build.check(rebuild, "rebuild", torch.int32, (batch,), s.device)
    if not 0 < base_n <= BASE_N:
        raise ValueError(f"herm_inv: base_n {base_n} not in [1, {BASE_N}]")
    if n > base_n:
        base, mm = herm_inv, cgemm
        mask = rebuild if gate is not None else active
        if mask is not None:   # the launches skip the other chains
            # (the gate's first base launch computes the mask)
            base = lambda m, *rest: herm_inv(m, *rest) if rest else \
                herm_inv(m, active=mask)
            mm = functools.partial(cgemm, active=mask)
        return blocked_herm_inv(s, base=base, mm=mm, base_n=base_n, out=out,
                                active=active, gate=gate, rebuild=rebuild)
    _build.check(s, "s", torch.complex64)
    if out is None:
        out = torch.empty_like(s)
    _build.call("herm_inv", "hk_herm_inv", _build.ptr(s), _build.ptr(out),
                batch, n, _build.ptr(active), _build.ptr(ps),
                _build.ptr(psx), float(drift_max), m, _build.ptr(rebuild))
    return out


def apply_refine(e, inv, rhs, refine: int = 1, mm=cgemm):
    """``x = inv rhs`` followed by ``refine`` steps ``x += inv (rhs - e x)``
    (``megastep.py:190-194``); ``mm`` is the product to use."""
    x = mm(inv, rhs)
    for _ in range(refine):
        r = mm(e, x, x=rhs, alpha=-1.0, beta=1.0)
        x = mm(inv, r, x=x, out=x)
    return x


def hermitian_solve(m: torch.Tensor, b: torch.Tensor, refine: int = 1,
                    jitter: float = 0.0, inv=herm_inv, mm=cgemm):
    """Jacobi-equilibrated solve of ``m x = b`` for Hermitian PD ``m``
    (B, n, n) and ``b`` (B, n, k), ``jitter`` added to the equilibrated
    diagonal: the counterpart of ``ops/pallas/spd_inv.py::spd_inv_solve``
    through its wrapper ``hermitian_solve_pallas2`` (:119-198). The inverse
    is :func:`herm_inv`, then ``x = A^-1 b`` and ``refine`` steps of
    ``x += A^-1 (b - A x)`` through :func:`cgemm` (``inv``/``mm``: the
    plain versions may be given instead). The real engine's
    ``solver="pallas2f"`` is this entry with ``refine=2``: the card has no
    counterpart of the TPU's 1-pass bf16 inverse build, and TF32 stays off,
    so the inverse is always built at FP32 grade. Each call on the card
    with the kernels counts one ``hermitian_solve`` launch."""
    ms, dinv = equilibrate(m, jitter)
    bs = (b * dinv[..., :, None]).contiguous()
    if inv is herm_inv and not _build.on_cpu(ms, bs):
        _build.count_entry("hermitian_solve")
    x = apply_refine(ms, inv(ms), bs, refine, mm=mm)
    return x * dinv[..., :, None]
