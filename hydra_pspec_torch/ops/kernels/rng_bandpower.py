"""Per-chain Philox4x32-10 streams and the bandpower conditional.

Kernels: ``csrc/rng_bandpower.cu`` (CUDA C++). They replace the TPU core
PRNG draws and Box-Muller of ``ops/pallas/megachain.py:238-302`` and the
in-kernel conditional ``_sample_bandpowers_body`` (:102-145). Streams are
keyed on (run seed, global chain stream id, global iteration); see
:mod:`hydra_pspec_torch.ops.philox`, the plain-torch twin that draws the
same words. Only the real engine launches ``rng_fields``, since the
megachain and mega engines draw their omegas inside ``draw_rhs`` and
``draw_system`` (:class:`draw_fused.OmegaKey`). A thread of ``rng_fields``
draws four consecutive time lanes of one row through ``philox.cuh``'s
``draw_lanes`` (the keyed passes' function: the row's Philox work is
shared by the four), the threads flat over the (row, lane chunk) space;
it is bound by the issue of its draws. Its time maps draw chosen times:
``tmap`` (lane j at time ``tmap[j]``), and the segment form
(:func:`rng_segments`), which draws the grouped real engine's time groups,
each at its own width, in one launch and with the bits of the full fields
gathered at the groups' times. ``bandpower`` runs a block per (chain, 32
bins) over the whole card: its warps split the Philox calls of the Gamma
draws, whose logs are summed in the serial order, and a bounded bin's
table searches are warp ballots of two rounds each.

Grouped time-flags mode (``ops/pallas/megachain.py:220-229, 256-263,
409-418``): ``rng_fields`` masks each row at its own time count
(``row_times``), and ``bandpower`` with ``group = G > 1`` pools ``beta``
over each chain's G chain-major rows, draws once per chain on the chain
stream, and writes that chain's ``ps`` to all G rows.
"""
from typing import NamedTuple

import numpy as np
import torch

from .. import philox
from ..invgamma import sample_bandpowers_from_beta
from . import _build

F32 = torch.float32
MAX_PRIOR_BINS = philox.N_PRIOR_UNIFORMS  # prior lanes of the conditional


class PriorBins(NamedTuple):
    """The bounded prior bins as device tensors (from ``prior_static``)."""

    idx: torch.Tensor   # (np,) int32 bin indices
    lo: torch.Tensor    # (np,) float32 lower bounds
    hi: torch.Tensor    # (np,) float32 upper bounds


def bounded_bins(prior) -> tuple:
    """Host (2, Nfreqs) prior -> ``((idx, lo, hi), ...)`` for every bounded
    bin (either bound > 0), with ``lo = prior[1]`` and ``hi = prior[0]``."""
    p = np.asarray(prior)
    idxs = np.nonzero(np.any(p > 0, axis=0))[0]
    return tuple((int(i), float(p[1, i]), float(p[0, i])) for i in idxs)


def prior_bins(prior_static, device) -> PriorBins:
    """``((idx, lo, hi), ...)`` -> :class:`PriorBins` on ``device``. The
    kernel takes any number of bins (the megachain engine at most
    :data:`MAX_PRIOR_BINS`, its TPU kernel's 8 prior lanes)."""
    idx = [int(p[0]) for p in prior_static]
    return PriorBins(
        torch.tensor(idx, dtype=torch.int32, device=device),
        torch.tensor([p[1] for p in prior_static], dtype=F32, device=device),
        torch.tensor([p[2] for p in prior_static], dtype=F32, device=device))


def _u32(v: int) -> int:
    return int(v) & philox.MASK32


# --- omega fields ----------------------------------------------------------

plain_rng_fields = philox.omega_fields  # the twin, on any device
LANES = 4   # time lanes a thread of the kernel (FIELD_LANES)


def rng_fields(seed: int, sids: torch.Tensor, g: int, n: int, t: int,
               ntimes: int, nfreqs: int, row_times=None, tmap=None):
    """The iteration-``g`` omegas ``(oa, ob)``, complex64 (B, n, t), of the
    chains ``sids`` (int32, on the device to draw on). ``row_times``:
    optional int32 (B,) per-row time counts replacing ``ntimes``;
    ``tmap``: optional int32 (t,) time counters, lane j drawing time
    ``tmap[j]`` in place of j."""
    if _build.on_cpu(sids, row_times, tmap):
        return plain_rng_fields(seed, sids, g, n, t, ntimes, nfreqs,
                                row_times, tmap)
    B = sids.shape[0]
    _build.check(sids, "sids", torch.int32, (B,))
    if row_times is not None:
        _build.check(row_times, "row_times", torch.int32, (B,), sids.device)
    if tmap is not None:
        _build.check(tmap, "tmap", torch.int32, (t,), sids.device)
    _check_chunks(B * n, -(-t // LANES))
    oa = torch.empty((B, n, t), dtype=torch.complex64, device=sids.device)
    ob = torch.empty_like(oa)
    _build.call("rng_fields", "hk_rng_fields", _u32(seed), _build.ptr(sids),
                _u32(g), _build.ptr(oa), _build.ptr(ob), B, n, t, ntimes,
                nfreqs, _build.ptr(row_times), _build.ptr(tmap), None, 0, 0)
    return oa, ob


def _check_chunks(rows: int, cpr: int):
    if rows * cpr >= 2 ** 31:
        raise ValueError(f"{rows} rows x {cpr} lane chunks: the kernel "
                         f"indexes fewer than 2^31 chunks")


class TimeSegments(NamedTuple):
    """Time groups to draw at their own widths in one launch
    (:func:`rng_segments`)."""

    idx: tuple            # each group's time indices, int64 tensors
    widths: tuple         # their counts t_g, host ints
    table: torch.Tensor   # int32: chunk offsets, time offsets, indices


def time_segments(idx) -> TimeSegments:
    """The segments of the time groups ``idx`` (integer tensors of time
    indices, all on the device to draw on). The table holds the segments'
    chunk offsets within a row (``LANES`` lanes a chunk) and time offsets,
    G + 1 of each, made on the host and copied to the device (a small
    synchronous copy: build it once for a chain, as
    ``tflags.run_chain_tflags_real`` does), then the indices
    concatenated."""
    idx = tuple(ix.to(torch.int64) for ix in idx)
    widths = tuple(int(ix.shape[0]) for ix in idx)
    coff, toff = [0], [0]
    for w in widths:
        coff.append(coff[-1] + -(-w // LANES))
        toff.append(toff[-1] + w)
    head = torch.tensor(coff + toff, dtype=torch.int32).to(idx[0].device)
    table = torch.cat([head] + [ix.to(torch.int32) for ix in idx])
    return TimeSegments(idx, widths, table)


def plain_rng_segments(seed: int, sids: torch.Tensor, g: int, n: int,
                       segs: TimeSegments, nfreqs: int):
    """The same function with the Philox twin, on any device."""
    return philox.omega_segments(seed, sids, g, n, segs.idx, nfreqs)


def rng_segments(seed: int, sids: torch.Tensor, g: int, n: int,
                 segs: TimeSegments, nfreqs: int):
    """Each time group's iteration-``g`` omegas at its own width, in one
    launch: ``(list of oa, list of ob)``, group g's pair complex64
    (B, n, t_g) holding the full fields' values at its times ``segs.idx[g]``
    (:func:`rng_fields` with ``tmap``). Each list's tensors are contiguous
    views of one buffer, the groups one after another."""
    if _build.on_cpu(sids, segs.table):
        return plain_rng_segments(seed, sids, g, n, segs, nfreqs)
    B, G = sids.shape[0], len(segs.widths)
    total = sum(segs.widths)
    _build.check(sids, "sids", torch.int32, (B,))
    _build.check(segs.table, "segs.table", torch.int32,
                 (2 * (G + 1) + total,), sids.device)
    chunks = sum(-(-w // LANES) for w in segs.widths)
    _check_chunks(B * n, chunks)
    oa = torch.empty((B * n * total,), dtype=torch.complex64,
                     device=sids.device)
    ob = torch.empty_like(oa)
    _build.call("rng_fields", "hk_rng_fields", _u32(seed), _build.ptr(sids),
                _u32(g), _build.ptr(oa), _build.ptr(ob), B, n, 0, 0,
                nfreqs, None, None, _build.ptr(segs.table), G, chunks)
    return _split(oa, B, n, segs.widths), _split(ob, B, n, segs.widths)


def _split(buf, B: int, n: int, widths):
    """The (B, n, t_g) views of the groups laid one after another."""
    out, o = [], 0
    for w in widths:
        out.append(buf[o:o + B * n * w].view(B, n, w))
        o += B * n * w
    return out


# --- bandpower conditional -------------------------------------------------

def _check_rand(gam, u_pb, sids):
    external = gam is not None
    if external == (sids is not None) or (u_pb is None) != (gam is None):
        raise ValueError("give either gam and u_pb, or seed and sids")
    return external


def _pool_rows(x, group: int):
    """(B, n) -> (B/group, n): the sum over each chain's ``group`` rows,
    taken in the kernel's order g = 0, 1, ..."""
    xv = x.view(-1, group, x.shape[1])
    out = xv[:, 0]
    for r in range(1, group):
        out = out + xv[:, r]
    return out


def plain_bandpower(beta, prior: PriorBins, tlog, q, *, gam=None, u_pb=None,
                    seed=None, sids=None, g=0, g_off: int = 0, alpha=None,
                    gam_out=False, group: int = 1):
    """The same function with ordinary torch ops and the Philox twin, on
    any device."""
    g = philox.iteration(g, g_off)
    if group > 1:
        beta = _pool_rows(beta, group)
        if gam is not None:
            gam, u_pb = gam[::group], u_pb[::group]
        if sids is not None:
            sids = sids[::group].to(torch.int64) + philox.CHAIN_STREAM_OFFSET
    if not _check_rand(gam, u_pb, sids):
        gam = philox.gamma_draws(seed, sids, g, beta.shape[1], alpha)
        u_pb = philox.prior_uniforms(seed, sids, g, prior.idx.shape[0])
    ps = sample_bandpowers_from_beta(beta, prior, tlog, q, gam=gam, u=u_pb)
    if group > 1:
        ps = ps.repeat_interleave(group, dim=0)
        gam = gam.repeat_interleave(group, dim=0)
    return (ps, gam) if gam_out else ps


def bandpower(beta, prior: PriorBins, tlog, q, *, gam=None, u_pb=None,
              seed=None, sids=None, g=0, g_off: int = 0, alpha=None,
              gam_out=False, group: int = 1):
    """Draw the new bandpowers (B, n) from ``beta`` (B, n).

    Randomness: external ``gam`` (B, n) and ``u_pb`` (B, >= bounded bins),
    or the streams of ``seed``/``sids`` at global iteration ``g + g_off``
    with Gamma shape ``alpha`` (any bin count: bounded bin l takes UNIFORM
    counter l // 4, lane l % 4); ``g`` is an int or a (1,) int32 tensor on
    the device, read when the kernel runs (a graph replay's counter).
    ``gam_out``: also return the Gamma draws.

    ``group = G > 1`` (grouped time-flags mode): rows come in chain-major
    blocks of G; ``beta`` is pooled over each block, ``sids`` holds each
    row's chain id and the draws are keyed on ``sids[c*G] + 2^30`` (or read
    from row ``c*G`` of ``gam``/``u_pb``); all G rows get the chain's
    ``ps`` and Gamma draws."""
    if _build.on_cpu(beta, gam, u_pb, sids, tlog, q,
                     g if torch.is_tensor(g) else None):
        return plain_bandpower(beta, prior, tlog, q, gam=gam, u_pb=u_pb,
                               seed=seed, sids=sids, g=g, g_off=g_off,
                               alpha=alpha, gam_out=gam_out, group=group)
    external = _check_rand(gam, u_pb, sids)
    B, n = beta.shape
    if group < 1 or B % group:
        raise ValueError(f"batch {B} is not a whole number of {group}-row "
                         f"chains")
    dev = beta.device
    _build.check(beta, "beta", F32, (B, n), dev)
    u_stride = 0
    if external:
        _build.check(gam, "gam", F32, (B, n), dev)
        _build.check(u_pb, "u_pb", F32, (B, None), dev)
        u_stride = u_pb.shape[1]
    else:
        _build.check(sids, "sids", torch.int32, (B,), dev)
    _build.check(tlog, "tlog", F32, (None,), dev)
    _build.check(q, "q", F32, tuple(tlog.shape), dev)
    npb = prior.idx.shape[0]
    for name, v in zip(("idx", "lo", "hi"), prior):
        _build.check(v, f"prior.{name}", v.dtype, (npb,), dev)
    g_val, g_dev = _build.iteration_args(g, g_off, dev)
    ps = torch.empty_like(beta)
    g_out = torch.empty_like(beta) if gam_out else None
    _build.call("bandpower", "hk_bandpower", _build.ptr(beta),
                _build.ptr(gam), _build.ptr(u_pb), u_stride,
                _u32(seed or 0), _build.ptr(sids), g_val, g_dev,
                int(alpha or 0), _build.ptr(tlog), _build.ptr(q),
                tlog.shape[0], _build.ptr(prior.idx), _build.ptr(prior.lo),
                _build.ptr(prior.hi), npb, _build.ptr(ps), _build.ptr(g_out),
                B, n, group)
    return (ps, g_out) if gam_out else ps


# --- raw words, for checking the kernel's generator against the twin -------

def philox_raw(ctr: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 of ``ctr`` (N, 4) under ``key`` (N, 2), int32 tensors
    holding uint32 bit patterns; returns (N, 4) int32."""
    if _build.on_cpu(ctr, key):
        c = ctr.to(torch.int64) & philox.MASK32
        k = key.to(torch.int64) & philox.MASK32
        words = philox.philox4x32(c[:, 0], c[:, 1], c[:, 2], c[:, 3],
                                  k[:, 0], k[:, 1])
        out = torch.stack(words, dim=1)
        return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(
            torch.int32)
    N = ctr.shape[0]
    _build.check(ctr, "ctr", torch.int32, (N, 4))
    _build.check(key, "key", torch.int32, (N, 2), ctr.device)
    out = torch.empty_like(ctr)
    _build.call("philox_raw", "hk_philox_raw", _build.ptr(ctr),
                _build.ptr(key), _build.ptr(out), N)
    return out
