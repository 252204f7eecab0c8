"""Chain constants in the time-transposed mega layout, and the
single-step mega engine (port of ``hydra_pspec_tpu/models/mega.py``).

Every per-time field is transposed to ``(B, n, t)``. The layout keeps the
data's own widths (:func:`layout_dims`): ``n`` is the channel count and
``m`` the mode count, unpadded, and ``t`` the time count rounded up to
even, the one pad a kernel of this package asks for (see
:class:`MegaDims`). ``layout="jax"`` builds the JAX package's layout
instead (widths padded to 128 lanes and 8 sublanes, the TPU's tiling):
every pad is an exact zero in every sum the kernels take, so a run at
either layout gives the same real lanes. Where the JAX package keeps a
``(re, im)`` float32 pair, this package keeps one complex64 tensor.
:meth:`MegaOperators.to_numpy` and :func:`from_jax_arrays` convert
between the two.

The mega engine (:func:`gibbs_step_mega`, :func:`run_chain_mega`) takes one
iteration per call of the ``gcr_megastep`` entry: it serves more than 8
bounded prior bins and ``Ntimes > 1025``, which the megachain engine does
not take. A call's iterations are one chunk: on the card with Philox
streams one CUDA graph (:class:`ops.kernels.graph.ChunkGraph`), as the
megachain engine runs, with the exact inverse every iteration. Sample
outputs are trimmed to the reference layout after the chunk.
"""
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.invgamma import InvGammaTable
from ..ops.kernels.draw_fused import OmegaKey
from ..ops.kernels.graph import replay_chunk
from ..ops.kernels.impl import KERNELS, Impl
from ..ops.kernels.megachain import ChainOut, chain_outputs
from ..ops.kernels.megastep import gcr_megastep
from .rgibbs import ChainSample, RChainOperators, bandpower_args, row_sum

# complex fields, each the JAX package's (<name>_re, <name>_im) pair
_COMPLEX = ("pt", "nid", "dw", "fg", "g", "mi", "a0", "f")
_REAL = ("nih", "ninv_full", "w")


class MegaDims(NamedTuple):
    """Static problem dims: the true widths and the layout's
    (:func:`layout_dims`)."""

    nfreqs: int      # true Nfreqs
    ntimes: int      # true Ntimes
    nmodes: int      # true Nmodes
    # channel width: nfreqs, no pad (herm_inv takes any n, split above 192
    # by blocked_herm_inv; cgemm zero-fills ragged tiles)
    n: int
    # time width: ntimes rounded up to even, so that every (n, t) row of a
    # complex64 field starts on 16 bytes: cgemm's 16-byte cp.async copies
    # of B and X, and the 16-byte lane pairs of draw_rhs and draw_system
    t: int
    # mode width: nmodes, no pad (cgemm takes any M and K)
    m: int
    all_unflagged: bool


LAYOUTS = ("port", "jax")


def layout_dims(nfreqs: int, ntimes: int, nmodes: int,
                layout: str = "port") -> tuple:
    """``(n, t, m)`` of the layout for the true widths: ``"port"`` this
    package's (:class:`MegaDims`), ``"jax"`` the JAX package's (multiples
    of 128, 128 and 8)."""
    if layout == "jax":
        up = lambda x, k: -(-x // k) * k
        return up(nfreqs, 128), up(ntimes, 128), up(nmodes, 8)
    if layout != "port":
        raise ValueError(f"layout must be one of {LAYOUTS}")
    return nfreqs, ntimes + ntimes % 2, nmodes


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
                         t_pad: Optional[int] = None,
                         layout: str = "port") -> tuple:
    """(a batch of) host chain operators -> (MegaOperators on ``device``,
    MegaDims) at ``layout`` (:func:`layout_dims`). ``t_pad`` forces the
    time width. Dense noise is refused, as in the JAX package: it runs on
    the real engine."""
    if ops.ni_dense is not None:
        raise NotImplementedError(
            "the mega layout takes diagonal noise; a dense Ninv runs on the "
            "real engine")
    B, T0, n0 = ops.d_w.shape
    m0 = ops.fg.shape[-1]
    n, t, m = layout_dims(n0, T0, m0, layout)
    if t_pad is not None:
        if t_pad < t:
            raise ValueError(f"t_pad={t_pad} < required padded width {t}")
        t = t_pad

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


def ln_post(noise_nu, bmask, ps):
    """Log posterior from the per-iteration vectors (any leading axes),
    summed in a fixed order (:func:`rgibbs.row_sum`)."""
    tiny = torch.finfo(torch.float32).tiny
    sig_term = row_sum(bmask / torch.clamp(ps, min=tiny))
    return -(row_sum(noise_nu) + sig_term)


def chi_mean(chit, dims: MegaDims, chi_mask):
    """Lean (K, B, n) time-reduced chi -> (K, B) mean over the true times
    and the (masked) channels."""
    nf, nt = dims.nfreqs, dims.ntimes
    if chi_mask is None:
        return torch.sum(chit[:, :, :nf], dim=2) / (nf * nt)
    cm = torch.as_tensor(np.asarray(chi_mask, np.float32)).to(chit.device)
    return torch.sum(chit[:, :, :nf] * cm, dim=2) / (torch.sum(cm) * nt)


def chain_sample(outs: ChainOut, dims: MegaDims, store_cr: bool,
                 chi_mask) -> ChainSample:
    """A chunk's padded outputs -> the sample in the reference layout (the
    per-time fields as views, trimmed and time-major)."""
    nf, nt, nm = dims.nfreqs, dims.ntimes, dims.nmodes
    lnp = ln_post(outs.noise_nu, outs.bmask, outs.ps)
    if store_cr:
        return ChainSample(
            signal_cr=outs.sig[:, :, :nf, :nt].transpose(2, 3),
            ps=outs.ps[:, :, :nf],
            fg_amps=outs.amp[:, :, :nm, :nt].transpose(2, 3),
            chisq=outs.chi[:, :, :nf, :nt].transpose(2, 3),
            ln_post=lnp)
    return ChainSample(signal_cr=None, ps=outs.ps[:, :, :nf], fg_amps=None,
                       chisq=chi_mean(outs.chit, dims, chi_mask),
                       ln_post=lnp)


def use_graph(graph: bool, randomness, impl: Impl, ps) -> bool:
    """A chunk runs as a :class:`ChunkGraph` when asked (``graph``) and it
    is the kernels' chunk on the card with Philox streams: external
    randomness is test input and the plain versions are the reference, so
    both run eagerly, as CPU tensors do."""
    return (graph and randomness is None and impl is KERNELS
            and ps.device.type == "cuda")


def gibbs_step_mega(mops: MegaOperators, dims: MegaDims, ps_pad, prior,
                    tlog, q, rand: dict, *, refine: int = 1,
                    store_cr: bool = True, impl: Impl = KERNELS,
                    sig_out=None, amp_out=None, chi_out=None):
    """One Gibbs alternation through the ``gcr_megastep`` entry
    (``mega.py:169-278``). ``ps_pad`` (B, n) padded bandpowers; ``prior``
    the bounded bins (any count); ``tlog``/``q`` the table rows. ``rand``:
    external (``oa``, ``ob`` complex64 (B, n, t), ``gam`` (B, n), ``u_pb``
    (B, >= bounded bins)) or the streams ``seed``, ``sids``, ``g`` (and
    optionally ``g_off``, added to ``g``; ``g`` may be a graph's device
    counter): the omegas are then the megachain engine's words for that
    chain and iteration, drawn inside ``draw_rhs`` and ``draw_system``
    (:class:`OmegaKey`), so with the exact inverse each iteration the two
    engines draw alike. ``*_out``: optional preallocated full-mode
    outputs. Returns ``(ps_new_pad, DrawOut)``; pad bins of
    ``ps_new_pad`` are held at exactly 0."""
    oa, ob, key = rand.get("oa"), rand.get("ob"), None
    if oa is None:
        key = OmegaKey(rand["seed"], rand["sids"], rand["g"],
                       rand.get("g_off", 0))
    d = gcr_megastep(mops, ps_pad, oa, ob, nfreqs=dims.nfreqs,
                     ntimes=dims.ntimes, all_unflagged=dims.all_unflagged,
                     refine=refine, lean=not store_cr, key=key, impl=impl,
                     sig_out=sig_out, amp_out=amp_out, chi_out=chi_out)
    ps_new = impl.bandpower(d.beta, prior, tlog, q,
                            **bandpower_args(rand, dims.ntimes - 1))
    keep = (torch.arange(dims.n, device=ps_pad.device)
            < dims.nfreqs).to(ps_new.dtype)
    return ps_new * keep, d


def mega_chunk_body(mops: MegaOperators, dims: MegaDims, prior, tlog, q, *,
                    seed=None, sids=None, randomness: Optional[dict] = None,
                    refine: int = 1, store_cr: bool = True,
                    impl: Impl = KERNELS):
    """``body(ps_pad, iter0, k_total) -> ChainOut``: ``k_total`` mega steps
    into preallocated (K, ...) padded outputs (a :class:`ChunkGraph`
    captures it; ``iter0`` an int or the graph's device counter).
    ``randomness``: external per-iteration arrays with a leading K axis, or
    None for the streams of ``seed``/``sids``."""
    def body(ps_pad, iter0, k_total):
        B, n = ps_pad.shape
        t, m = mops.nid.shape[2], mops.fg.shape[2]
        out = chain_outputs(k_total, B, n, t, m, not store_cr, ps_pad.device)
        ps = ps_pad
        for k in range(k_total):
            rand = (dict(seed=seed, sids=sids, g=iter0, g_off=k)
                    if randomness is None
                    else {name: v[k] for name, v in randomness.items()})
            slot = {f"{name}_out": out[name][k] for name in ("sig", "amp",
                                                             "chi")
                    if store_cr}
            ps, d = gibbs_step_mega(mops, dims, ps, prior, tlog, q, rand,
                                    refine=refine, store_cr=store_cr,
                                    impl=impl, **slot)
            out["ps"][k] = ps
            out["noise_nu"][k] = d.noise_nu
            out["bmask"][k] = d.bmask
            if not store_cr:
                out["chit"][k] = d.chit
        return ChainOut(ps_final=ps, **out)

    return body


def run_chain_mega(mops: MegaOperators, dims: MegaDims, ps0_pad, prior,
                   niter: int, tlog, q, *, seed=None, sids=None,
                   iter0: int = 0, randomness: Optional[dict] = None,
                   refine: int = 1, store_cr: bool = True, chi_mask=None,
                   impl: Impl = KERNELS, graph: bool = True,
                   graphs: Optional[dict] = None):
    """``niter`` mega steps from ``ps0_pad`` as one chunk (``mega.py:281-297``
    runs them as a Python loop). Randomness as :func:`rgibbs.run_chain`,
    with the omegas in the layout's ``(B, n, t)`` (the runner cuts fields
    drawn at the JAX package's widths to it: ``megachain.randomness_on``).
    ``chi_mask`` (optional (nfreqs,) 0/1, lean runs): the chi^2 mean over
    the masked channels. ``graph``/``graphs``: as
    ``megachain.run_chunk_megachain`` (on the card with the streams the
    chunk is a :class:`ChunkGraph`, and the sample holds views of its
    outputs until its next replay).
    Returns ``(ps_pad_final, ChainSample)`` trimmed to the true widths."""
    body = lambda: mega_chunk_body(mops, dims, prior, tlog, q, seed=seed,
                                   sids=sids, randomness=randomness,
                                   refine=refine, store_cr=store_cr,
                                   impl=impl)
    if use_graph(graph, randomness, impl, ps0_pad):
        key = ("mega", niter, store_cr, refine)
        outs = replay_chunk({} if graphs is None else graphs, key, body,
                            ps0_pad, niter, iter0)
    else:
        outs = body()(ps0_pad, iter0, niter)
    return outs.ps_final, chain_sample(outs, dims, store_cr, chi_mask)
