"""Chain constants in the padded, time-transposed megachain layout (port of
``hydra_pspec_tpu/models/mega.py:25-166``).

The layout is the JAX package's: frequencies padded to a multiple of 128
(``n``), times to a multiple of 128 (``t``), modes to a multiple of 8
(``m``), and every per-time field transposed to ``(B, n, t)``. Where the
JAX package keeps a ``(re, im)`` float32 pair, this package keeps one
complex64 tensor. :meth:`MegaOperators.to_numpy` and
:func:`from_jax_arrays` convert between the two.
"""
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.invgamma import InvGammaTable
from .rgibbs import RChainOperators

# complex fields, each the JAX package's (<name>_re, <name>_im) pair
_COMPLEX = ("pt", "nid", "dw", "fg", "g", "mi", "a0", "f")
_REAL = ("nih", "ninv_full", "w")


class MegaDims(NamedTuple):
    """Static problem dims."""

    nfreqs: int      # true Nfreqs
    ntimes: int      # true Ntimes
    nmodes: int      # true Nmodes
    n: int           # padded freq dim (multiple of 128)
    t: int           # padded time dim (multiple of 128)
    m: int           # padded mode dim (multiple of 8)
    all_unflagged: bool


class MegaOperators(NamedTuple):
    """Chain constants on one device; complex fields are complex64."""

    pt: torch.Tensor         # (B, n, n) P-tilde
    nih: torch.Tensor        # (B, n) sqrt(Ni) diagonal
    nid: torch.Tensor        # (B, n, t) Ni (d - Fg a0)
    # FG-deflated masked visibilities d_w - Fg a0, deflated in float64 on
    # the host, so the in-kernel FG product sees only the small deviation
    dw: torch.Tensor         # (B, n, t)
    ninv_full: torch.Tensor  # (B, n)
    w: torch.Tensor          # (B, n)
    fg: torch.Tensor         # (B, n, m)
    g: torch.Tensor          # (B, n, m) G = Ni Fg Maa^-1
    mi: torch.Tensor         # (B, m, m) Maa^-1
    a0: torch.Tensor         # (B, m, t) host GLS amplitudes
    f: torch.Tensor          # (n, n) centered DFT, shared
    igt: InvGammaTable       # shared, host numpy

    def to_numpy(self) -> dict:
        """The JAX package's field names and float32 (re, im) pairs."""
        out = {}
        for name in _COMPLEX:
            z = getattr(self, name).cpu().numpy()
            out[f"{name}_re"] = np.ascontiguousarray(z.real)
            out[f"{name}_im"] = np.ascontiguousarray(z.imag)
        for name in _REAL:
            out[name] = getattr(self, name).cpu().numpy()
        out["igt_log_y"] = self.igt.log_y
        out["igt_q"] = self.igt.q
        out["igt_alpha"] = self.igt.alpha
        return out


def from_jax_arrays(arrays: dict, dims: MegaDims, device) -> MegaOperators:
    """Operators from the JAX package's ``MegaOperators`` given as numpy
    arrays under its field names (``pt_re``, ``pt_im``, ``nih``, ...,
    ``f_im``, plus ``igt_log_y``, ``igt_q``, ``igt_alpha``). ``dims`` is
    checked against the shapes."""
    def cplx(name):
        re = np.array(arrays[f"{name}_re"], np.float32)
        im = np.array(arrays[f"{name}_im"], np.float32)
        return torch.complex(torch.from_numpy(re),
                             torch.from_numpy(im)).to(device)

    fields = {name: cplx(name) for name in _COMPLEX}
    for name in _REAL:
        fields[name] = torch.from_numpy(
            np.array(arrays[name], np.float32)).to(device)
    fields["igt"] = InvGammaTable(
        log_y=np.asarray(arrays["igt_log_y"], np.float32),
        q=np.asarray(arrays["igt_q"], np.float32),
        alpha=np.asarray(arrays["igt_alpha"], np.float32))
    mops = MegaOperators(**fields)
    if (mops.pt.shape[1] != dims.n or mops.nid.shape[2] != dims.t
            or mops.fg.shape[2] != dims.m):
        raise ValueError(f"array shapes do not match {dims}")
    return mops


def _pad_np(x, shape):
    out = np.zeros(shape, dtype=x.dtype)
    out[tuple(slice(0, s) for s in x.shape)] = x
    return out


def from_chain_operators(ops: RChainOperators, device,
                         t_pad: Optional[int] = None) -> tuple:
    """(a batch of) host chain operators -> (MegaOperators on ``device``,
    MegaDims). ``t_pad`` forces the padded time width."""
    B, T0, n0 = ops.d_w.shape
    m0 = ops.fg.shape[-1]
    n = -(-n0 // 128) * 128
    t = -(-T0 // 128) * 128
    if t_pad is not None:
        if t_pad < t:
            raise ValueError(f"t_pad={t_pad} < required padded width {t}")
        t = t_pad
    m = -(-m0 // 8) * 8

    c64 = lambda z: np.asarray(z).astype(np.complex64)

    def tpad(z, d2, d3, transpose=False):
        z = c64(z)
        if transpose:
            z = np.swapaxes(z, 1, 2)
        return _pad_np(z, (B, d2, d3))

    # FG-deflate the residual baseline in float64 (see MegaOperators.dw)
    dw64 = c64(ops.d_w).astype(np.complex128)
    fg64 = c64(ops.fg).astype(np.complex128)
    a064 = c64(ops.a0).astype(np.complex128)
    dw_defl = dw64 - np.einsum("bxm,btm->btx", fg64, a064)
    vec = lambda v: _pad_np(np.asarray(v, dtype=np.float32), (B, n))
    host = dict(
        pt=tpad(ops.p_tilde, n, n),
        nih=vec(ops.nih_diag),
        nid=tpad(ops.ni_d, n, t, transpose=True),
        dw=tpad(dw_defl, n, t, transpose=True),
        ninv_full=vec(ops.ninv_full_diag),
        w=vec(ops.w),
        fg=tpad(ops.fg, n, m),
        g=tpad(ops.g_mat, n, m),
        mi=tpad(ops.maa_inv, m, m),
        a0=tpad(ops.a0, m, t, transpose=True),
        f=_pad_np(c64(ops.f), (n, n)),
    )
    mops = MegaOperators(
        **{k: torch.from_numpy(v).to(device) for k, v in host.items()},
        igt=ops.igt)
    all_unflagged = bool(np.all(np.asarray(ops.w) == 1))
    return mops, MegaDims(n0, T0, m0, n, t, m, all_unflagged)


def broadcast_mega_operators(mops: MegaOperators, batch: int) -> MegaOperators:
    """Tile a batch-of-one operator set to ``batch`` identical chains."""
    body = {k: getattr(mops, k).expand((batch,) + getattr(mops, k).shape[1:])
            .contiguous()
            for k in MegaOperators._fields if k not in ("f", "igt")}
    return MegaOperators(**body, f=mops.f, igt=mops.igt)


def pad_ps(ps, dims: MegaDims, device) -> torch.Tensor:
    """(B, nfreqs) bandpowers -> padded float32 (B, n) on ``device``; pad
    bins carry 0 and stay 0 through the sampler (beta = 0 there)."""
    ps = torch.as_tensor(np.asarray(ps, np.float32) if not torch.is_tensor(ps)
                         else ps).to(device=device, dtype=torch.float32)
    out = torch.zeros((ps.shape[0], dims.n), dtype=torch.float32,
                      device=device)
    out[:, :dims.nfreqs] = ps
    return out
