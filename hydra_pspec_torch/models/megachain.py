"""Driver of the K-iteration chain (port of
``hydra_pspec_tpu/models/megachain.py:28-56, 200-407, 478-565``).

Randomness comes in two forms:

* ``seed`` and ``sids`` (production): per-chain Philox streams keyed on
  (seed, global chain id, global iteration), drawn by the kernels on CUDA
  and by the plain-torch twin on the CPU. A chain's samples depend on
  those three values only;
* ``randomness`` (pinning tests): explicit per-iteration arrays, in the
  JAX package's dict layout (``oa_re``, ``oa_im``, ``ob_re``, ``ob_im``,
  ``gam``, ``u_pb``), each with a leading K axis.

The grouped time-flags mode (``group_times``, ``sidc``, ``group_idx``;
``:88-197, 410-475``) runs a flag signature's chains as chain-major
(chain, time group) rows: see :class:`TflagsMegaSetup`.

On the card with Philox streams a chunk runs as one CUDA graph
(:class:`ops.kernels.graph.ChunkGraph`, ``graph=True``, the default),
captured at first use and replayed; ``graph=False`` runs the same kernels
from Python, launch by launch (the eager path the graph is checked
against). External randomness and CPU tensors always run eagerly.

Not ported (they raise): the TPU scheduling knobs ``prefetch_rng`` and
``batch_tile``, bf16 pass counts other than 3, a mesh, and the raw
position-seeded seed mode of the JAX package.
"""
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import philox
from ..ops.invgamma import make_invgamma_table
from ..ops.kernels.graph import replay_chunk
from ..ops.kernels.impl import KERNELS, Impl
from ..ops.kernels.megachain import TimeScatter, gcr_megachain
from ..ops.kernels.rng_bandpower import (MAX_PRIOR_BINS, bounded_bins,
                                         prior_bins)
from .mega import (MegaDims, MegaOperators, chain_sample, chi_mean,
                   from_chain_operators, from_jax_arrays, layout_dims,
                   ln_post, use_graph)
from .rgibbs import ChainSample

MAX_TIME_GROUPS = 8


class MegaChainTables(NamedTuple):
    """The InvGammaTable rows as float32 device tensors. (The JAX package
    tiles them to 8 sublanes; a CUDA kernel needs one row.)"""

    tlog: torch.Tensor  # (S,) log y
    q: torch.Tensor     # (S,) Q(alpha, y)


def make_chain_tables(mops: MegaOperators, device) -> MegaChainTables:
    return MegaChainTables(
        tlog=torch.from_numpy(np.array(mops.igt.log_y, np.float32)).to(
            device),
        q=torch.from_numpy(np.array(mops.igt.q, np.float32)).to(device))


def prior_static_from(prior, dims: MegaDims):
    """Host (2, Nfreqs-or-n) prior -> ``((idx, lo, hi), ...)`` for the
    bounded bins, with ``lo = prior[1]`` and ``hi = prior[0]``."""
    static = bounded_bins(prior)
    if len(static) > MAX_PRIOR_BINS:
        raise ValueError(
            f"megachain supports <= {MAX_PRIOR_BINS} bounded prior bins; "
            f"got {len(static)}: run the single-step engine (engine='mega')")
    return static


# --- grouped time-flags layout ---------------------------------------------

class TflagsMegaSetup(NamedTuple):
    """One flag signature in the grouped layout: each chain spans G
    consecutive rows (chain-major), row ``c*G + g`` carrying the operators
    of time group g, every group padded to the same ``t_req`` time lanes:
    the largest group's time count, rounded as :func:`mega.layout_dims`
    rounds it. G is the number of flag patterns. (At the JAX package's
    layout G is rounded up to a power of two and the dummy groups have
    zero operators and ``group_times`` 0, so they add exactly 0 to every
    pooled statistic.) ``mops.igt`` is the table at alpha + 1 = the TOTAL
    time count, the shape of the pooled conditional. A row's stream is
    ``sid*G_key + g`` whatever G is (:func:`philox.grouped_stream_ids`)."""

    mops: MegaOperators   # (Bc*G, ...) rows, chain-major
    dims: MegaDims        # ntimes = TOTAL true times, t = t_req; flagged
    group_times: tuple    # per row-group true time count (0 = dummy)
    group_idx: tuple      # per REAL group: its time indices


def _interleave(per, G):
    """Per-group operator batches (Bc, ...) -> chain-major rows (Bc*G, ...),
    zero operators for the dummy groups."""
    per = list(per) + [None] * (G - len(per))
    fields = {}
    for name in MegaOperators._fields:
        if name in ("f", "igt"):
            continue
        xs = [getattr(m, name) for m in per if m is not None]
        xs += [torch.zeros_like(xs[0])] * (G - len(xs))
        s = torch.stack(xs, dim=1)
        fields[name] = s.reshape((-1,) + tuple(s.shape[2:]))
    return fields


def build_tflags_mega_setup(groups, device,
                            layout: str = "port") -> TflagsMegaSetup:
    """``groups``: ``tflags.TimeGroupReal`` whose ``ops`` are stacked over
    the signature's (baseline, chain) batch, one entry per time group ->
    the grouped layout on ``device`` (``models/megachain.py:107-156``):
    G = the group count at ``layout="port"``; at ``"jax"`` G rounded up to
    a power of two and each group padded to a multiple of 128 times."""
    g_real = len(groups)
    if g_real > MAX_TIME_GROUPS:
        raise ValueError(f"grouped megachain supports <= {MAX_TIME_GROUPS} "
                         f"time groups; got {g_real}")
    G = philox.key_group(g_real) if layout == "jax" else g_real
    ops0 = groups[0].ops
    widths = lambda g: layout_dims(ops0.d_w.shape[2], g.ops.d_w.shape[1],
                                   ops0.fg.shape[-1], layout)
    t_req = max(widths(g)[1] for g in groups)
    per = [from_chain_operators(g.ops, device, t_pad=t_req, layout=layout)
           for g in groups]
    d0 = per[0][1]
    ntimes_total = sum(d.ntimes for _, d in per)
    mops = MegaOperators(**_interleave([m for m, _ in per], G),
                         f=per[0][0].f, igt=make_invgamma_table(ntimes_total))
    dims = MegaDims(d0.nfreqs, ntimes_total, d0.nmodes, d0.n, t_req, d0.m,
                    False)
    group_times = tuple(d.ntimes for _, d in per) + (0,) * (G - g_real)
    return TflagsMegaSetup(mops, dims, group_times,
                           tuple(np.asarray(g.idx) for g in groups))


def tflags_setup_from_jax_arrays(arrays: dict, dims: MegaDims, group_times,
                                 group_idx, device) -> TflagsMegaSetup:
    """The port's setup from the JAX package's ``TflagsMegaSetup`` given as
    numpy arrays (``mops`` fields as in :func:`mega.from_jax_arrays`)."""
    return TflagsMegaSetup(from_jax_arrays(arrays, dims, device), dims,
                           tuple(int(x) for x in group_times),
                           tuple(np.asarray(i) for i in group_idx))


def grouped_randomness(rows: dict, gam_c, u_c, group: int) -> dict:
    """External randomness in the grouped layout
    (``draw_chunk_randomness_tflags``, ``models/megachain.py:159-197``):
    ``rows`` holds the per-row omegas (``oa_re`` ... ``ob_im``, (K, B, n,
    t)); the per-chain Gamma draws ``gam_c`` (K, Bc, n) and uniforms
    ``u_c`` (K, Bc, >=8) are repeated over each chain's ``group`` rows."""
    rep = lambda x: np.repeat(np.asarray(x), group, axis=1)
    return dict(rows, gam=rep(gam_c), u_pb=rep(u_c))


def time_scatter(group_times, group_idx, dims: MegaDims,
                 device) -> TimeScatter:
    """Each true time's (row in the chain's block, lane) from
    ``group_idx``, for the per-iteration gather into time order."""
    row = np.full(dims.ntimes, -1, np.int64)
    lane = np.zeros(dims.ntimes, np.int64)
    for g, idx in enumerate(group_idx):
        idx = np.asarray(idx)
        if idx.size != group_times[g]:
            raise ValueError(f"group {g}: {idx.size} indices for "
                             f"{group_times[g]} times")
        row[idx] = g
        lane[idx] = np.arange(idx.size)
    if (row < 0).any():
        raise ValueError("group_idx does not cover every time")
    as_t = lambda a: torch.from_numpy(a).to(device)
    return TimeScatter(len(group_times), as_t(row), as_t(lane),
                       dims.nfreqs, dims.nmodes)


def randomness_on(randomness: dict, device, dims: Optional[MegaDims] = None
                  ) -> dict:
    """JAX-layout external randomness -> device tensors: complex64 ``oa``
    and ``ob`` (where given as ``_re``/``_im`` pairs), float32 ``gam`` and
    ``u_pb``. With ``dims``, fields wider than its layout (the JAX
    package's 128-lane pads) are cut to its ``(n, t)`` and ``gam`` to its
    ``n``: the kernels read no lane beyond a row's true widths."""
    def t(x):
        if torch.is_tensor(x):
            return x.to(device=device, dtype=torch.float32)
        return torch.from_numpy(np.array(x, np.float32)).to(device)

    n, tw = (None, None) if dims is None else (dims.n, dims.t)
    cut = lambda x, *w: x[(...,) + tuple(slice(k) for k in w)].contiguous()
    out = dict(gam=cut(t(randomness["gam"]), n), u_pb=t(randomness["u_pb"]))
    for name in ("oa", "ob"):
        if f"{name}_re" in randomness:
            out[name] = cut(torch.complex(t(randomness[f"{name}_re"]),
                                          t(randomness[f"{name}_im"])),
                            n, tw)
    return out


def chunk_body(mops: MegaOperators, tables: MegaChainTables, dims: MegaDims,
               prior_static=(), *, seed: Optional[int] = None, sids=None,
               randomness: Optional[dict] = None, refine: int = 1,
               lean: bool = False, warm_ns: int = 0, drift_max: float = 0.25,
               group_times=(), sidc=None, group_idx=(),
               impl: Impl = KERNELS):
    """``body(ps_pad, iter0, k_total) -> ChainOut``: a chunk of
    :func:`gcr_megachain` with every tensor it needs (stream ids, prior
    bins, per-row time counts, the time scatter) made now, on the device of
    ``mops``, so that the body copies nothing from the host (a
    :class:`ChunkGraph` captures it). ``iter0`` is an int, or the graph's
    device counter. Arguments as :func:`run_chunk_megachain` (``randomness``
    already on the device, as :func:`randomness_on` gives it)."""
    G = len(group_times) if len(group_times) > 1 else 1
    device = mops.nid.device
    if randomness is not None:
        seed = sids = None
    else:
        if seed is None or sids is None or (G > 1 and sidc is None):
            raise ValueError(
                "give seed and sids, and sidc in grouped mode (the raw "
                "position-seeded mode of the JAX package is not "
                "composition-invariant and is not ported)")
        sids = _ids_on(sids, device)
        sidc = None if G == 1 else _ids_on(sidc, device)
    grouped = {}
    if G > 1:
        bc = mops.nid.shape[0] // G
        grouped = dict(
            group=G, sidc=sidc,
            row_times=torch.tensor(list(group_times) * bc, dtype=torch.int32,
                                   device=device),
            scatter=(None if lean else
                     time_scatter(group_times, group_idx, dims, device)))
    prior = prior_bins(prior_static, device)

    def body(ps_pad, iter0, k_total):
        return gcr_megachain(
            mops, tables.tlog, tables.q, ps_pad, k_total,
            nfreqs_true=dims.nfreqs, ntimes_true=dims.ntimes,
            alpha_int=dims.ntimes - 1, all_unflagged=dims.all_unflagged,
            prior=prior, refine=refine, warm_ns=warm_ns,
            drift_max=drift_max, lean=lean, randomness=randomness,
            seed=seed, sids=sids, iter0=iter0, impl=impl, **grouped)

    return body


def run_chunk_megachain(
    mops: MegaOperators,
    tables: MegaChainTables,
    dims: MegaDims,
    ps_pad: torch.Tensor,
    k_total: int,
    prior_static=(),
    *,
    seed: Optional[int] = None,
    sids=None,
    iter0: int = 0,
    randomness: Optional[dict] = None,
    refine: int = 1,
    store_cr: bool = True,
    chi_mask=None,
    inv_passes: int = 3,
    apply_passes: int = 3,
    warm_ns: int = 0,
    drift_max: float = 0.25,
    prefetch_rng: bool = False,
    group_times=(),
    sidc=None,
    group_idx=(),
    impl: Impl = KERNELS,
    graph: bool = True,
    graphs: Optional[dict] = None,
):
    """One chunk of ``k_total`` iterations on ``ps_pad``'s device.

    ``chi_mask`` (optional (nfreqs,) 0/1, lean mode only): the scalar
    chi^2 is averaged over the masked channels. ``warm_ns > 0``: carry the
    system inverse across the chunk's iterations with that many
    Newton-Schulz steps while the chain's relative bandpower move stays
    under ``drift_max``. ``impl``: the kernels (default) or the plain torch
    versions (``ops.kernels.impl.PLAIN``). Returns ``(ps_pad_final,
    ChainSample)``.

    ``graph`` (default True): with the kernels on the card and Philox
    streams the chunk runs as a :class:`ChunkGraph`; the sample then holds
    views of the graph's outputs, valid until its next replay. ``graphs``:
    optional dict of the caller's graphs for this run's operators, streams
    and prior, keyed by chunk size and mode; a graph is captured at the
    first chunk of each key and replayed after (default: one graph for
    this call).

    ``group_times`` with more than one entry selects the grouped
    time-flags mode (:class:`TflagsMegaSetup`): ``mops``, ``ps_pad`` and
    ``sids`` (row streams ``sid*G_key + g``,
    :func:`philox.grouped_stream_ids`) are per row, ``sidc`` the chain id
    of each row, ``dims.ntimes`` the total time count and ``group_idx`` the
    real groups' time indices. The sample's batch axis is then CHAINS;
    ``ps_pad_final`` stays per row."""
    G = len(group_times) if len(group_times) > 1 else 1
    if prefetch_rng:
        raise NotImplementedError(
            "prefetch_rng is a TPU scheduling mode; it has no port")
    if inv_passes != 3 or apply_passes != 3:
        raise NotImplementedError(
            "inv_passes/apply_passes count bf16 passes of the TPU matmul; "
            "the port computes in full float32 (only the default 3 is "
            "accepted)")
    lean = not store_cr
    rnd = (None if randomness is None
           else randomness_on(randomness, ps_pad.device, dims))
    make_body = lambda: chunk_body(
        mops, tables, dims, prior_static, seed=seed, sids=sids,
        randomness=rnd, refine=refine, lean=lean, warm_ns=warm_ns,
        drift_max=drift_max, group_times=group_times, sidc=sidc,
        group_idx=group_idx, impl=impl)
    if use_graph(graph, rnd, impl, ps_pad):
        key = ("megachain", k_total, lean, G, warm_ns, drift_max, refine)
        outs = replay_chunk({} if graphs is None else graphs, key, make_body,
                            ps_pad, k_total, iter0)
    else:
        outs = make_body()(ps_pad, iter0, k_total)
    if G > 1:
        return outs.ps_final, _assemble_grouped(outs, dims, G, store_cr,
                                                chi_mask)
    return outs.ps_final, chain_sample(outs, dims, store_cr, chi_mask)


def _ids_on(ids, device):
    return (ids.to(device=device, dtype=torch.int32) if torch.is_tensor(ids)
            else torch.as_tensor(np.asarray(ids, np.int32)).to(device))


def _assemble_grouped(outs, dims: MegaDims, G: int, store_cr: bool,
                      chi_mask) -> ChainSample:
    """Grouped outputs (rows = chain x group) -> per-chain sample
    (``models/megachain.py:410-475``): ``noise_nu``, ``bmask`` and the lean
    ``chi_t`` summed over each chain's rows, ``ps`` from row ``c*G``,
    ``ln_post`` from the pooled values. The per-time fields are already in
    time order (gathered per iteration through ``group_idx``)."""
    dei = lambda x: x.view(x.shape[0], -1, G, *x.shape[2:])
    nf = dims.nfreqs
    ps_c = dei(outs.ps)[:, :, 0]
    lnp = ln_post(torch.sum(dei(outs.noise_nu), dim=2),
                  torch.sum(dei(outs.bmask), dim=2), ps_c)
    if store_cr:
        return ChainSample(signal_cr=outs.sig, ps=ps_c[:, :, :nf],
                           fg_amps=outs.amp, chisq=outs.chi, ln_post=lnp)
    chit = torch.sum(dei(outs.chit), dim=2)
    return ChainSample(signal_cr=None, ps=ps_c[:, :, :nf], fg_amps=None,
                       chisq=chi_mean(chit, dims, chi_mask), ln_post=lnp)


def auto_chunk(niter: int, batch: int, dims: MegaDims,
               store_cr: bool) -> int:
    """Iterations per chunk (K) when the caller does not pin one.

    The JAX package sized K against a TPU's remote dispatch round trip.
    Here a chunk is a sequence of kernel launches, so K only bounds the
    device memory of one chunk's sample outputs (about 1 GiB) and the
    warm-start resets (one exact rebuild per chunk); the same quantized
    policy is kept so both packages chunk a run alike."""
    target = max(100, 6400 // max(batch, 1))
    # sized at the JAX package's layout, whatever this run's layout is, so
    # that both packages (and every layout) chunk a run alike
    n, t, m = layout_dims(dims.nfreqs, dims.t, dims.nmodes, "jax")
    if store_cr:
        bytes_per = 4 * (3 * n * t + 2 * m * t + 3 * n)
    else:
        bytes_per = 4 * 4 * n
    cap = (1 << 30) // max(1, batch * bytes_per)
    k = min(target, max(100, cap), 1600, max(100, niter))
    return max(100, (k // 100) * 100)


def _clone(sample: ChainSample) -> ChainSample:
    return ChainSample(*(None if x is None else x.clone() for x in sample))


def _cat(pieces):
    if len(pieces) == 1:
        return pieces[0]
    fields = {}
    for name in ChainSample._fields:
        xs = [getattr(p, name) for p in pieces]
        fields[name] = None if xs[0] is None else torch.cat(xs, 0)
    return ChainSample(**fields)


def run_chain_megachain(
    mops: MegaOperators,
    dims: MegaDims,
    ps0_pad: torch.Tensor,
    prior,
    niter: int,
    *,
    seed: Optional[int] = None,
    sids=None,
    iter0: int = 0,
    randomness=None,
    tables: Optional[MegaChainTables] = None,
    store_cr: bool = True,
    chi_mask=None,
    refine: int = 1,
    chunk: Optional[int] = None,
    warm_ns: int = 0,
    drift_max: float = 0.25,
    group_times=(),
    sidc=None,
    group_idx=(),
    graph: bool = True,
    graphs: Optional[dict] = None,
):
    """A whole chain of ``niter`` iterations in chunks (default
    :func:`auto_chunk`), on ``ps0_pad``'s device. The streams continue at
    global iteration ``iter0``. ``randomness``: optional callable
    ``(iteration, k_total) -> dict`` of external randomness per chunk.
    ``group_times``/``sidc``/``group_idx``: the grouped time-flags mode of
    :func:`run_chunk_megachain`. ``graph``/``graphs``: as there; without
    ``graphs`` the chunks of this call share their graphs (at most one per
    chunk size: the chunk and a shorter tail). Returns ``(ps_pad_final,
    ChainSample over niter)``; with a graph the last chunk's part holds
    views of its outputs, valid until its next replay."""
    if tables is None:
        tables = make_chain_tables(mops, ps0_pad.device)
    prior_static = prior_static_from(prior, dims)
    if chunk is None:
        chunk = auto_chunk(niter, ps0_pad.shape[0], dims, store_cr)
    chunk = min(niter, chunk)
    graphs = {} if graphs is None else graphs
    ps = ps0_pad
    pieces = []
    it = 0
    while it < niter:
        k_total = min(chunk, niter - it)
        ps, sample = run_chunk_megachain(
            mops, tables, dims, ps, k_total, prior_static,
            seed=seed, sids=sids, iter0=iter0 + it,
            randomness=(None if randomness is None
                        else randomness(iter0 + it, k_total)),
            refine=refine, store_cr=store_cr, chi_mask=chi_mask,
            warm_ns=warm_ns, drift_max=drift_max, group_times=group_times,
            sidc=sidc, group_idx=group_idx, graph=graph, graphs=graphs)
        it += k_total
        # a graph's next replay overwrites this chunk's outputs
        pieces.append(sample if it >= niter else _clone(sample))
    return ps, _cat(pieces)
