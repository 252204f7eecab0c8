"""Host-side chain operator build (port of
``hydra_pspec_tpu/models/rgibbs.py:36-147``).

Everything is numpy, computed in float64 and stored at ``dtype`` (float32
by default, complex fields as complex64), exactly as the JAX package stores
them. The sampler engine of that module (the real-pair step) is not ported:
only the megachain engine runs in this package.
"""
from typing import NamedTuple

import numpy as np

from ..ops.fourier import dft_matrix
from ..ops.invgamma import InvGammaTable, make_invgamma_table

DENSE_NINV_ITEM = ("a dense Ninv runs only on the real engine, which is not "
                   "ported yet (ROADMAP.md, Queue 1 item 9)")


class RChainOperators(NamedTuple):
    """Per-chain constants with a leading batch axis B. ``f`` and ``igt``
    are shared across the batch. Complex fields are complex numpy arrays."""

    d_w: np.ndarray             # (B, Ntimes, Nfreqs) masked visibilities
    w: np.ndarray               # (B, Nfreqs) flags
    f: np.ndarray               # (Nfreqs, Nfreqs) centered DFT, shared
    ni_diag: np.ndarray         # (B, Nfreqs)
    nih_diag: np.ndarray        # (B, Nfreqs)
    ninv_full_diag: np.ndarray  # (B, Nfreqs)
    fg: np.ndarray              # (B, Nfreqs, Nmodes)
    ni_d: np.ndarray            # (B, Ntimes, Nfreqs) Ni (d - Fg a0)
    a0: np.ndarray              # (B, Ntimes, Nmodes) host GLS amplitudes
    p_tilde: np.ndarray         # (B, Nfreqs, Nfreqs) F (Ni - G (Ni Fg)^H) F^H / n
    g_mat: np.ndarray           # (B, Nfreqs, Nmodes) Ni Fg Maa^-1
    maa_inv: np.ndarray         # (B, Nmodes, Nmodes)
    igt: InvGammaTable          # shared


def build_chain_operators(vis, w, fgmodes, ninv,
                          dtype=np.float32) -> RChainOperators:
    """Build a batch-of-one chain. ``ninv``: scalar, (Nfreqs,) diagonal or
    a diagonal (Nfreqs, Nfreqs) matrix. A genuinely dense ``ninv`` raises
    ``NotImplementedError``."""
    vis = np.asarray(vis, dtype=np.complex128)
    nfreqs = vis.shape[-1]
    w = np.asarray(w, dtype=np.float64)
    ninv = np.asarray(ninv)
    if ninv.ndim == 2:
        if np.abs(ninv - np.diag(np.diag(ninv))).max() > 0:
            raise NotImplementedError(DENSE_NINV_ITEM)
        ninv = np.diag(ninv).real
    ninv_full = np.broadcast_to(np.real(ninv), (nfreqs,)).astype(np.float64)
    ni = w * ninv_full * w
    nih = np.sqrt(ni)
    fg = np.asarray(fgmodes, dtype=np.complex128)
    d_w = vis * w

    ni_fg = ni[:, None] * fg
    maa = fg.conj().T @ ni_fg
    # FG deflation: amplitudes are solved relative to the float64 GLS fit
    rhs0 = fg.conj().T @ (ni * d_w).T
    a0 = np.linalg.lstsq(maa, rhs0, rcond=None)[0].T
    d_defl = d_w - a0 @ fg.T
    ni_d = ni * d_defl
    maa_inv = np.linalg.pinv(maa)
    g_mat = ni_fg @ maa_inv
    p_mat = np.diag(ni).astype(complex) - g_mat @ ni_fg.conj().T
    i_idx = np.arange(nfreqs) - nfreqs // 2
    f_op = np.exp(-2j * np.pi * np.outer(i_idx, i_idx) / nfreqs)
    p_tilde = f_op @ p_mat @ f_op.conj().T / nfreqs

    # complex128 -> complex64 rounds each part to nearest, as the JAX
    # package's separate float32 casts of re and im do
    cdt = np.result_type(dtype, np.complex64)
    cv = lambda z: np.asarray(z)[None].astype(cdt)
    rv = lambda x: np.asarray(np.asarray(x)[None], dtype=dtype)
    return RChainOperators(
        d_w=cv(d_w), w=rv(w), f=dft_matrix(nfreqs, dtype=dtype),
        ni_diag=rv(ni), nih_diag=rv(nih), ninv_full_diag=rv(ninv_full),
        fg=cv(fg), ni_d=cv(ni_d), a0=cv(a0), p_tilde=cv(p_tilde),
        g_mat=cv(g_mat), maa_inv=cv(maa_inv),
        igt=make_invgamma_table(vis.shape[0], dtype=dtype),
    )


def stack_chain_operators(ops_list) -> RChainOperators:
    """Concatenate batches of chains along the batch axis; the shared
    fields come from the first element."""
    fields = {name: np.concatenate([getattr(o, name) for o in ops_list])
              for name in RChainOperators._fields if name not in ("f", "igt")}
    return RChainOperators(**fields, f=ops_list[0].f, igt=ops_list[0].igt)
