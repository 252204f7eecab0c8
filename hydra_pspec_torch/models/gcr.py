"""Gaussian constrained realization of the EoR signal and the foreground
amplitudes in complex128: the complex float64 engine's draw (port of
``hydra_pspec_tpu/models/gcr.py:41-166``).

With the signal whitened, ``s = Sh u``, the reference's block system
(pspec.py:151-374) becomes Hermitian positive definite,

    M = [[I + Sh Ni Sh,  Sh Ni F ],      b = [ Sh (Ni d + Nih w_b) + w_a ]
         [F^H Ni Sh,     F^H Ni F]]          [ F^H (Ni d + Nih w_b)      ]

with ``Sh = F_op^H diag(sqrt(ps) / n^1.5) F_op`` analytic. M is
Jacobi-equilibrated, factored once per iteration (``cholesky_ex``) and
solved for every time as one multi-right-hand-side pair of triangular
solves. No kernel of the JAX package lies on this path: it is plain XLA
there and plain torch here, on the card in complex128.

Every function takes a leading batch axis (the runner's (baseline x
chain) rows) or none; the Fourier operator is shared. One chain's
operators also serve a batch of chains of that baseline: :func:`gcr_solve`
broadcasts them against batched ``ps`` and omegas.
"""
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.fourier import fourier_operator
from ..ops.linalg import NoiseOperators, cholesky_solve, make_noise_operators


class ChainOperators(NamedTuple):
    """The iteration-invariant constants of a chain (``gcr.py:41-61``):
    ``d_w`` (..., Ntimes, Nfreqs) masked visibilities, ``w`` (...,
    Nfreqs), ``fgmodes`` (..., Nfreqs, Nmodes), the shared
    ``fourier_op``, the noise operators, ``ni_d = Ni (d_w - Fg a0)``, ``ni_fg
    = Ni Fg``, ``maa = Fg^H Ni Fg`` and the GLS foreground shift ``a0``
    (..., Ntimes, Nmodes)."""

    d_w: torch.Tensor
    w: torch.Tensor
    fgmodes: torch.Tensor
    fourier_op: torch.Tensor
    noise: NoiseOperators
    ni_d: torch.Tensor
    ni_fg: torch.Tensor
    maa: torch.Tensor
    a0: torch.Tensor


def build_chain_operators(vis, w, fgmodes, ninv, dtype=torch.complex128,
                          device="cpu") -> ChainOperators:
    """One chain's constants (``gcr.py:64-97``), built on the host in
    ``dtype`` and moved to ``device``. ``ninv``: a scalar, (Nfreqs,)
    diagonal or (Nfreqs, Nfreqs) dense inverse noise."""
    rdtype = torch.empty((), dtype=dtype).real.dtype
    vis = torch.as_tensor(np.asarray(vis)).to(dtype)
    nfreqs = vis.shape[-1]
    w = torch.as_tensor(np.asarray(w)).to(rdtype)
    fg = torch.as_tensor(np.asarray(fgmodes)).to(dtype)
    ninv = torch.as_tensor(np.asarray(ninv))
    noise = make_noise_operators(w, ninv)
    noise = NoiseOperators(
        noise.ni_diag.to(rdtype), noise.nih_diag.to(rdtype),
        noise.ninv_full_diag.to(rdtype),
        None if noise.ni_dense is None else noise.ni_dense.to(dtype),
        None if noise.nih_dense is None else noise.nih_dense.to(dtype))
    d_w = vis * w
    ni_fg = (noise.ni_diag[:, None] * fg if noise.is_diagonal
             else noise.ni_dense @ fg)
    maa = fg.mH @ ni_fg
    # foreground deflation: amplitudes relative to the GLS fit a0
    rhs0 = fg.mH @ noise.apply_ni(d_w).mT
    a0 = torch.linalg.lstsq(maa, rhs0, driver="gelsd").solution.mT
    ni_d = noise.apply_ni(d_w - a0 @ fg.mT)
    ops = ChainOperators(d_w, w, fg, fourier_operator(nfreqs, dtype, "cpu"),
                         noise,
                         ni_d, ni_fg, maa, a0)
    return to_device(ops, device)


def map_chains(ops: ChainOperators, fn) -> ChainOperators:
    """``fn`` on every per-chain tensor; the Fourier operator as is."""
    noise = NoiseOperators(*(None if x is None else fn(x)
                             for x in ops.noise))
    return ops._replace(**{name: fn(getattr(ops, name))
                           for name in ("d_w", "w", "fgmodes", "ni_d",
                                        "ni_fg", "maa", "a0")},
                        noise=noise)


def to_device(ops: ChainOperators, device) -> ChainOperators:
    out = map_chains(ops, lambda x: x.to(device))
    return out._replace(fourier_op=ops.fourier_op.to(device))


def stack_chain_operators(ops_list) -> ChainOperators:
    """Chains stacked on a new leading batch axis; the Fourier operator is
    the first's. Dense and diagonal noise do not mix in one batch."""
    dense = {o.noise.ni_dense is not None for o in ops_list}
    if len(dense) > 1:
        raise ValueError("a batch mixes dense and diagonal Ninv")
    first = ops_list[0]
    fields = {name: torch.stack([getattr(o, name) for o in ops_list])
              for name in ("d_w", "w", "fgmodes", "ni_d", "ni_fg", "maa",
                           "a0")}
    noise = NoiseOperators(*(
        None if first.noise[k] is None
        else torch.stack([o.noise[k] for o in ops_list])
        for k in range(len(first.noise))))
    return ChainOperators(**fields, fourier_op=first.fourier_op, noise=noise)


def signal_sqrt_operator(ops: ChainOperators, ps: torch.Tensor):
    """``Sh = F^H diag(sqrt(ps) / n^1.5) F`` (``gcr.py:100-110``), (...,
    n, n) for ``ps`` (..., n)."""
    n = ps.shape[-1]
    sh_delay = torch.sqrt(torch.clamp(ps, min=0.0)) / (n * math.sqrt(n))
    f = ops.fourier_op
    return (f.mH * sh_delay[..., None, :].to(f.dtype)) @ f


class GCRResult(NamedTuple):
    signal_cr: torch.Tensor   # (..., Ntimes, Nfreqs) in-painted signal
    fg_amps: torch.Tensor     # (..., Ntimes, Nmodes) foreground amplitudes
    info: torch.Tensor        # (...) int32 cholesky_ex status, 0 = factored


def gcr_solve(ops: ChainOperators, ps: torch.Tensor,
              omega_a: Optional[torch.Tensor],
              omega_b: Optional[torch.Tensor],
              jitter: float = 0.0) -> GCRResult:
    """Constrained realizations for every time at once (``gcr.py:119-
    166``). ``omega_a``/``omega_b`` (..., Ntimes, Nfreqs) standard complex
    normals, or None for both: the MAP estimate. The result also carries
    the factor's ``info`` (see :func:`ops.linalg.cholesky_solve`)."""
    nfreqs = ops.d_w.shape[-1]
    dtype = ops.d_w.dtype
    sh = signal_sqrt_operator(ops, ps)
    ni_sh = (ops.noise.ni_diag[..., :, None] * sh if ops.noise.is_diagonal
             else ops.noise.ni_dense @ sh)
    muu = torch.eye(nfreqs, dtype=dtype, device=sh.device) + sh @ ni_sh
    mua = sh @ ops.ni_fg
    maa = ops.maa.expand(mua.shape[:-2] + ops.maa.shape[-2:])
    m = torch.cat([torch.cat([muu, mua], dim=-1),
                   torch.cat([mua.mH, maa], dim=-1)], dim=-2)

    # right-hand sides for all times, (..., Nparams, Ntimes)
    rc = ops.ni_d
    if omega_b is not None:
        rc = rc + ops.noise.apply_nih(omega_b)
    b_top = sh @ rc.mT
    if omega_a is not None:
        b_top = b_top + omega_a.mT
    b = torch.cat([b_top, ops.fgmodes.mH @ rc.mT], dim=-2)

    # Jacobi equilibration before the factorisation
    d = torch.sqrt(torch.clamp(torch.diagonal(m, dim1=-2, dim2=-1).real,
                               min=torch.finfo(ps.dtype).tiny))
    dinv = (1.0 / d).to(dtype)
    m_scaled = m * (dinv[..., :, None] * dinv[..., None, :])
    x, info = cholesky_solve(m_scaled, dinv[..., :, None] * b, jitter=jitter)
    x = dinv[..., :, None] * x
    signal = (sh @ x[..., :nfreqs, :]).mT
    return GCRResult(signal, x[..., nfreqs:, :].mT + ops.a0, info)
