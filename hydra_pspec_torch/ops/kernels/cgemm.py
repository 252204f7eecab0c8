"""Batched complex64 matrix product ``C = alpha * op(A) B + beta * X``.

Kernel: ``csrc/cgemm.cu``. It replaces every matrix product inside the TPU
kernel ``gcr_megachain`` (``ops/pallas/megastep.py:41`` ``_cmm``, used at
``:145-152, 191-194, 203-207, 221, 233``, and the Newton-Schulz steps of
``ops/pallas/megachain.py:385-388``), and the products of the blocked
Hermitian inverse and factor-solve. At the main path's large products
(120 x 120 x 204 a chain: n = 120 channels, t = 204 times) it is bound by
the FP32 FMA rate. Its tiles fit those widths: 60 x 68 output tiles of
4 x 4 complex accumulators a thread (255 threads) cover 120 x 204 with no
pad, 60 x 40 tiles cover 120 x 120 and the grouped rows' 80 times, 64 x 64
tiles the widths that are multiples of 64, each fed by a ``cp.async`` ring
of K tiles; the M <= 16 and K <= 16 products have their own tiles, and
16 x 64 tiles also serve small batches. The C launcher plans the tile
from the shape and the batch count (the tile that computes the least
pad, unless its blocks fill less than half the SMs). No
tensor cores (TF32 would bring back the precision loss the reference
rejected) and no split-K: every output is one thread's sum over k in
ascending order, so the bits do not depend on the tile, and each chain's
output depends on that chain alone.

CPU tensors take :func:`plain_cgemm`; CUDA tensors launch the kernel.
"""
import torch

from . import _build

OPS = {"N": 0, "T": 1, "H": 2}
# the kernel's tiles (BM x BN, K tile) in the order of csrc/cgemm.cu's
# TileId: the index that its C entries hk_cgemm_tile takes and
# hk_cgemm_plan returns
TILES = ("16x64 k16", "32x64 k16", "64x64 k16", "60x68 k12", "60x40 k8")


def _op(a, op):
    if op == "N":
        return a
    at = a.transpose(-2, -1)
    return at.conj() if op == "H" else at


def plain_cgemm(a, b, *, op="N", x=None, alpha=1.0, beta=1.0, out=None,
                active=None):
    """The same function with ordinary torch ops, on any device."""
    c = torch.matmul(_op(a, op), b)
    if alpha != 1.0:
        c = c * alpha
    if x is not None:
        c = c + (x if beta == 1.0 else beta * x)
    if out is None:
        return c
    if active is not None:
        c = torch.where(active[:, None, None] != 0, c, out)
    out.copy_(c)
    return out


def cgemm(a, b, *, op="N", x=None, alpha=1.0, beta=1.0, out=None,
          active=None):
    """``alpha * op(a) @ b + beta * x`` for complex64 ``a`` (B, ., .) or
    shared (., .), ``b`` (B, K, N) and optional ``x`` (B, M, N). ``out``
    may be ``x`` itself, never ``a`` or ``b``. ``active`` (optional int32
    (B,)): batch elements flagged 0 are skipped and keep their ``out``."""
    if op not in OPS:
        raise ValueError(f"op must be one of {sorted(OPS)}")
    if _build.on_cpu(a, b, x, out, active):
        return plain_cgemm(a, b, op=op, x=x, alpha=alpha, beta=beta, out=out,
                           active=active)
    batch, K, N = b.shape
    if a.dim() == 2:
        a_batched = 0
    elif a.dim() == 3 and a.shape[0] == batch:
        a_batched = 1
    else:
        raise ValueError(f"a: shape {tuple(a.shape)} for batch {batch}")
    M = a.shape[-2] if op == "N" else a.shape[-1]
    ka = a.shape[-1] if op == "N" else a.shape[-2]
    if ka != K:
        raise ValueError(f"inner dims differ: {ka} vs {K}")
    dev = b.device
    _build.check(a, "a", torch.complex64, device=dev)
    _build.check(b, "b", torch.complex64, device=dev)
    if x is not None:
        _build.check(x, "x", torch.complex64, (batch, M, N), dev)
    if out is None:
        out = torch.empty((batch, M, N), dtype=torch.complex64, device=dev)
    else:
        _build.check(out, "out", torch.complex64, (batch, M, N), dev)
        if out.data_ptr() in (a.data_ptr(), b.data_ptr()):
            raise ValueError("out may not alias a or b")
    if active is not None:
        _build.check(active, "active", torch.int32, (batch,), dev)
    _build.call("cgemm", "hk_cgemm", _build.ptr(a), _build.ptr(b),
                _build.ptr(x), _build.ptr(out), batch, M, N, K, OPS[op],
                a_batched, float(alpha), float(beta), _build.ptr(active))
    return out
