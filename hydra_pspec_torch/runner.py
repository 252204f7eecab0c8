"""Multi-baseline, multi-chain execution on a device, a block of devices
or a process of a multi-process run (port of ``hydra_pspec_tpu/runner.py``).

The (baseline x chain) product is one batch axis, run by one of four
engines, routed as the JAX runner routes them (:func:`route_engine`):

* ``megachain`` (the default, ``models/megachain.py``): K whole iterations
  per chunk on the hand-written kernels;
* ``mega`` (``models/mega.py``): one ``gcr_megastep`` per iteration, for
  more than 8 bounded prior bins or ``Ntimes > 1025``;
* ``real`` (``models/rgibbs.py``): the unpadded real engine with the
  factor-solve kernel, for a dense ``Ninv``, MAP mode, and time flags with
  more than 8 patterns (``models/tflags.py``);
* ``complex`` (``models/gibbs.py``): the complex float64 engine, the
  correctness tier, only when asked for (``engine="complex"``, or
  ``precision x64`` in the CLI): complex128 with Cholesky solves, a chunk
  a CUDA graph on the card; it runs everything itself (dense ``Ninv``,
  MAP, any prior) and its time-flags path runs one baseline at a time.

Samples are flushed every ``write_niter`` iterations with the reference's
file names, and a run-level checkpoint allows resume with complete output
files. Every chain's randomness is keyed on (seed, global chain stream id,
global iteration) on every engine, so a subset of baselines or a resumed
run reproduces the same chains. A different ``write_niter`` does not on
the megachain engine: its warm start rebuilds every inverse at a chunk's
first iteration (on the card, chunks of 100 and of 50 differ in every
sample file).

The host side of a chunk (``runner.py:473-575`` of the JAX package): chunk
i+1 is dispatched before chunk i's samples are fetched, flushed and
checkpointed, at chunk i's own state and iteration. On the card the
megachain and mega engines run each chunk as a CUDA graph in one of two
slots alternated by chunk parity (``ops/kernels/graph.py::GraphSlots``),
so chunk i's outputs stay valid while chunk i+1 runs; chunk i's samples
and state leave on a copy stream through two pinned staging buffers of
64 MiB, reused in turn, and the compute stream waits on that copy before
it replays the slot again. The files go through one native writer pool per run
(``utils/fastio.py``), drained before every checkpoint, so no checkpoint
records an iteration whose files are not on disk. ``overlap=False`` runs
the serial loop instead (eager chunks, synchronous copies).

Jobs with time-dependent flags (``flags_tf``) run the grouped time-flags
path (``runner.py:775-1109`` of the JAX package): baselines with identical
flag arrays form a signature and run as one batch, one signature after
another, each with its own checkpoint: on the megachain engine as
chain-major (chain, time group) rows (``models/megachain.py::
TflagsMegaSetup``), on the real engine one group after another.

More than one process (``num_processes``, the CLI's ``--num_processes``):
each process runs its own block of baselines on its own device, the
streams keyed on ``global_baseline_ids``, and checkpoints under its own
tag (``checkpoint-p{pid}.npz``; ``-tf{s}-p{pid}`` per flag signature), as
the JAX runner does (``runner.py:299-340, 430, 800-811, 989-990``).
Nothing crosses processes while sampling (``parallel/dist.py``).

More than one device in a process (``mesh_devices``, the counterpart of
``runner.py:341-365``): the (baseline x chain) rows are split into
contiguous blocks (``dist.shard_rows``), each built and run on its own
device with its own chunk graphs, fetch and state (:class:`_Shard`, on
every engine of the plain path); chunk i is dispatched on every shard
before chunk i-1 is processed, and the shards' host chunks are joined in
row order, so the files and the checkpoint are those of a one-device run.
A chain's bits depend on (seed, global chain id, iteration) only, with
one exception: ``all_unflagged`` is decided per batch (``models/mega.py``,
ROADMAP.md Queue 3), so an unflagged shard split off a batch with flagged
chains can differ from the whole batch in the last bits; bit identity
holds for batches of one flag state. The time-flags path splits each
signature's (baseline x chain) rows over the devices the same way, whole
chains to a shard (a grouped chain's G rows stay together; the JAX
runner's chain-whole padding, ``runner.py:861-920``), on the megachain
and real engines; the complex engine's signatures, one baseline each, run
on the first device, as in the JAX package. It keeps a serial loop and
``np.save``, as the JAX package's does.
"""
import contextlib
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from .models import gcr, gibbs, mega, megachain, rgibbs, tflags
from .ops import philox
from .ops.invgamma import make_invgamma_table
from .ops.kernels import rng_bandpower as rb
from .ops.kernels.graph import GraphSlots
from .parallel.dist import shard_rows
from .utils import io as hio
from .utils.fastio import AsyncNpyWriter

MAX_NTIMES = 1025
ENGINES = ("megachain", "mega", "real", "complex")


@dataclass
class BaselineJob:
    """One baseline's inference inputs (reference run-hydra-pspec.py:462)."""

    antpair: tuple
    d: np.ndarray              # (Ntimes, Nfreqs) complex, noise-injected
    w: np.ndarray              # (Nfreqs,) 1 = keep
    fgmodes: np.ndarray        # (Nfreqs, Nmodes)
    S_initial: np.ndarray      # (Nfreqs, Nfreqs) or bandpowers (Nfreqs,)
    Ninv: np.ndarray           # (Nfreqs,) diag, (Nfreqs, Nfreqs), or scalar
    out_dir: Optional[Path] = None
    # (Ntimes, Nfreqs) bool, True = flagged: the grouped time-flags path
    # runs instead of the per-channel ``w`` (which it then ignores)
    flags_tf: Optional[np.ndarray] = None


@dataclass
class RunResult:
    antpair: tuple
    chain: int
    signal_ps: np.ndarray      # (Niter, Nfreqs)
    ln_post: np.ndarray        # (Niter,)
    chisq: np.ndarray
    signal_cr: Optional[np.ndarray]
    fg_amps: Optional[np.ndarray]
    signal_S: np.ndarray
    out_dir: Optional[Path]
    write_time: float = 0.0


def _initial_ps_host(S_initial, nfreqs):
    """Bandpower state from an initial covariance (host numpy)."""
    S0 = np.asarray(S_initial)
    if S0.ndim == 1:
        return np.clip(S0.real, 0.0, None)
    i = np.arange(nfreqs) - nfreqs // 2
    F = np.exp(-2j * np.pi * np.outer(i, i) / nfreqs)
    ps = np.diagonal(F @ S0 @ F.conj().T).real / nfreqs**2 * nfreqs**2
    return np.clip(ps, 0.0, None)


def _max_tflag_groups(jobs):
    """Most distinct flag rows (time groups) over the jobs' ``flags_tf``
    (0 when none carries time-dependent flags)."""
    return max([len(np.unique(np.asarray(j.flags_tf, dtype=bool), axis=0))
                for j in jobs if j.flags_tf is not None], default=0)


def select_engine(engine: str = "auto") -> str:
    """``auto`` is the megachain engine on any device (the port's policy;
    :func:`route_engine` then sends what it does not cover elsewhere);
    ``megachain``, ``mega``, ``real`` and ``complex`` are taken as given
    (the JAX package picks ``complex`` under x64, ``runner.py:109-123``;
    the port's CLI does so for ``precision x64``)."""
    if engine == "auto":
        return "megachain"
    if engine in ENGINES:
        return engine
    raise ValueError(f"unknown engine {engine!r}")


def route_engine(jobs, ps_prior, engine: str = "auto",
                 map_estimate: bool = False) -> str:
    """The engine that runs ``jobs``: ``hydra_pspec_tpu/runner.py:180-211``
    rule for rule. Megachain gives way to mega for MAP mode, more than 8
    bounded prior bins, ``Ntimes > 1025`` or more than 8 flag patterns;
    mega and megachain give way to real for MAP mode or a dense ``Ninv``;
    mega gives way to real for time flags. The complex engine runs
    everything itself."""
    engine = select_engine(engine)
    if engine == "megachain":
        n_prior = int(np.count_nonzero(np.any(np.asarray(ps_prior) > 0,
                                              axis=0)))
        if (map_estimate or n_prior > megachain.MAX_PRIOR_BINS
                or jobs[0].d.shape[0] > MAX_NTIMES
                or _max_tflag_groups(jobs) > megachain.MAX_TIME_GROUPS):
            engine = "mega"
    if engine in ("mega", "megachain") and (
            map_estimate or any(rgibbs.is_dense(j.Ninv) for j in jobs)):
        engine = "real"
    if engine == "mega" and any(j.flags_tf is not None for j in jobs):
        engine = "real"
    return engine


def _global_ids(ids, nbl, num_processes, n_global):
    """The jobs' global baseline indices, which key their streams: given,
    or ``0 .. nbl-1`` in a one-process run. With more than one process
    they must be given, or every rank would repeat rank 0's streams."""
    if ids is None:
        if num_processes > 1:
            raise ValueError("a run over more than one process needs "
                             "global_baseline_ids (they key the streams)")
        return list(range(nbl))
    ids = [int(i) for i in ids]
    if len(ids) != nbl or (n_global is not None and any(
            not 0 <= i < n_global for i in ids)):
        raise ValueError(f"global_baseline_ids {ids} do not index "
                         f"{nbl} of {n_global} baselines")
    return ids


def _on(device):
    """``device`` made current for the launches of a block (the kernels
    launch on the current device's stream)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _sync(devices):
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _chunk_randomness(randomness, it, k, device, dims=None, **kw):
    """One chunk's external randomness on ``device``, or None; with the
    mega engine's ``dims``, cut to its layout
    (:func:`megachain.randomness_on`)."""
    if randomness is None:
        return None
    return megachain.randomness_on(randomness(it, k, **kw), device, dims)


def _complex_randomness(randomness, it, k, device, **kw):
    """One chunk's external randomness of the complex engine (``oa``,
    ``ob``, ``gam``, ``u`` with a leading K axis) on ``device``, or None."""
    if randomness is None:
        return None
    return {name: torch.as_tensor(np.asarray(v)).to(device)
            for name, v in randomness(it, k, **kw).items()}


def run_baselines(
    jobs: Sequence[BaselineJob],
    ps_prior: np.ndarray,
    niter: int,
    *,
    device="cuda",
    seed: Optional[int] = None,
    nchains: int = 1,
    write_niter: int = 100,
    map_estimate: bool = False,
    store_cr: bool = True,
    jitter: float = 0.0,
    engine: str = "auto",
    solver: str = "auto",
    warm_ns: int = 3,
    drift_max: float = 0.6,
    checkpoint: bool = True,
    checkpoint_niter: int = 0,
    resume: bool = False,
    run_dir: Optional[Path] = None,
    process_id: int = 0,
    num_processes: int = 1,
    n_global_baselines: Optional[int] = None,
    mesh_devices: Optional[Sequence] = None,
    global_baseline_ids: Optional[Sequence[int]] = None,
    randomness: Optional[Callable] = None,
    verbose: bool = False,
    overlap: bool = True,
    profile_dir=None,
):
    """Run Gibbs chains for every (baseline, chain) pair on ``device`` (the
    card by default; ``device="cpu"`` runs the plain versions of the
    kernels); returns ``(results, timings)`` with one :class:`RunResult`
    per pair. ``timings["engine"]`` names the engine that ran
    (:func:`route_engine`). On the card the megachain and mega engines run
    each chunk of ``write_niter`` iterations as one CUDA graph, captured
    in both slots at the run's first chunk (and in its own slot for a
    shorter last chunk) and replayed (``ops/kernels/graph.py``), unless
    ``randomness`` is given.

    ``overlap`` (default True): chunk i+1 is dispatched before chunk i is
    fetched and flushed, its samples copied through pinned staging on a copy
    stream on the card (module docstring). False: the serial loop, each
    chunk run eagerly (no graph), fetched by a synchronous ``.cpu()`` and
    flushed before the next; the same kernels, so the same bits.
    ``profile_dir``: a ``torch.profiler`` trace (CPU, and CUDA on the
    card) of one turn of the loop in steady state -- the second chunk's
    dispatch, copy and device work and the host's processing of the
    first, between two device synchronizations -- or of the first chunk
    when it is the only one, written there as ``chunk-<i>.trace.json``.

    ``map_estimate``: the MAP estimate (no fluctuation draws), one
    iteration on the real engine, or the complex one when it is asked for
    (``niter`` and ``write_niter`` become 1).
    ``solver`` / ``jitter``: the real engine's Hermitian solve (``auto``,
    ``chol``, ``pallas``, ``pallas2``, ``pallas2f``; see
    ``models/rgibbs.py``) and the jitter added to its equilibrated
    diagonal. ``checkpoint_niter``: checkpoint cadence in iterations
    (rounded up to whole ``write_niter`` chunks); 0 = every chunk.
    ``warm_ns`` / ``drift_max``: megachain engine only, Newton-Schulz
    refresh steps of the carried system inverse and the largest relative
    bandpower move that trusts it (0 disables). ``global_baseline_ids``:
    the baselines' global indices, which key their streams (required with
    more than one process). ``process_id`` / ``num_processes`` /
    ``n_global_baselines``: ``jobs`` is process ``process_id``'s block of
    a run over ``num_processes`` (the CLI's block rule) of
    ``n_global_baselines`` in all; it runs on ``device`` and checkpoints
    under the tag ``-p{process_id}`` (module docstring). ``mesh_devices``:
    the devices the rows are split over in this process (default
    ``[device]``); more than one runs a shard per device (module
    docstring), on the plain and the time-flags paths, and refuses
    ``randomness``. ``randomness``:
    optional callable ``(iteration, k_total) -> dict`` of external
    randomness per chunk in the JAX package's layout (``oa_re``, ``oa_im``,
    ``ob_re``, ``ob_im`` in the engine's omega layout, ``gam``, ``u_pb``,
    each with a leading K axis; on the complex engine ``oa``, ``ob``,
    ``gam`` and ``u`` as ``models/gibbs.py`` takes them), for pinning
    against it (the megachain and mega engines cut fields drawn at the
    JAX package's 128-lane widths to their own layout); default is the
    Philox streams of ``seed``. On the time-flags path it is called as
    ``randomness(iteration, k_total, sids=row stream ids, sidc=chain id of
    each row, group=G)`` on the megachain engine (G the group count, rows
    keyed ``sid*G_key + g``) and ``randomness(
    iteration, k_total, sids=chain ids)`` on the real engine (omegas over
    all times), since each signature has its own rows.

    Jobs with ``flags_tf`` (a job without it in such a run gets all-False
    flags) run the grouped time-flags path: each signature checkpoints at
    every flush (``checkpoint_niter`` is not read there, as in the JAX
    package), and ``timings`` sums ``scatter`` (host build and transfer)
    and ``process`` (sampling and flushes) over the signatures.

    ``timings`` also splits the host side: ``write`` (flush, pool drain
    and checkpoint seconds, as the JAX runner counts it), ``flush`` (the
    host's submissions), ``pool_wait`` (``writer.wait()``), ``pool`` (the
    pool threads' write seconds), ``fetch_wait`` (waiting for a chunk's
    copy), ``staging`` (pinned staging into the kept numpy chunks),
    ``pin_alloc`` (allocating the staging), ``pinned_bytes``,
    ``is_native`` and, on the card, the two graph slots' pool bytes
    (``graph_pool_bytes``)."""
    if map_estimate:
        niter = write_niter = 1
    engine = route_engine(jobs, ps_prior, engine, map_estimate)
    device = torch.device(device)
    devices = ([torch.device(d) for d in mesh_devices] if mesh_devices
               else [device])
    seed = 0 if seed is None else int(seed)
    gids = _global_ids(global_baseline_ids, len(jobs), num_processes,
                       n_global_baselines)
    # per-process checkpoints (``runner.py:430`` of the JAX package)
    ck_tag = f"-p{process_id}" if num_processes > 1 else ""
    if randomness is not None and len(devices) > 1:
        raise ValueError("external randomness runs on one device")
    if any(j.flags_tf is not None for j in jobs):
        if engine == "complex" and num_processes > 1:
            raise NotImplementedError(
                "time flags on the complex float64 engine run in one "
                "process only (as in the JAX package)")
        return _run_baselines_tflags(
            jobs, ps_prior, niter, devices=devices, seed=seed,
            nchains=nchains, write_niter=write_niter, store_cr=store_cr,
            engine=engine, warm_ns=warm_ns, drift_max=drift_max,
            checkpoint=checkpoint, resume=resume, run_dir=run_dir,
            gids=gids, ck_tag=ck_tag, randomness=randomness,
            verbose=verbose, map_estimate=map_estimate, jitter=jitter,
            solver=solver)
    nbl = len(jobs)
    nfreqs = jobs[0].d.shape[-1]
    meta = [(ib, ic) for ib in range(nbl) for ic in range(nchains)]
    if run_dir is None and jobs[0].out_dir is not None:
        run_dir = Path(jobs[0].out_dir).parent
    prior_host = np.asarray(ps_prior, dtype=np.float64)

    # --- build the chain constants, a block of rows per device ------------
    t_scatter0 = time.perf_counter()
    build = (gcr.build_chain_operators if engine == "complex"
             else rgibbs.build_chain_operators)
    per_bl = [build(j.d, j.w, j.fgmodes, j.Ninv) for j in jobs]
    ps_host = np.stack([_initial_ps_host(jobs[ib].S_initial, nfreqs)
                        for ib, _ in meta])
    # global chain stream ids: a chain's draws depend on this id only
    sid_host = np.asarray([gids[ib] * nchains + ic for ib, ic in meta],
                          dtype=np.int32)
    shards = [_Shard(engine, [per_bl[meta[r][0]] for r in rows], rows,
                     ps_host, sid_host, prior_host, dev, overlap)
              for dev, rows in zip(devices, shard_rows(len(meta),
                                                       len(devices)))
              if len(rows)]
    del per_bl
    _sync(devices)
    t_scatter = time.perf_counter() - t_scatter0

    def run_chunk(sh, n, done, graphs):
        if engine == "megachain":
            return megachain.run_chain_megachain(
                sh.ops, sh.dims, sh.ps, prior_host, n, seed=seed,
                sids=sh.sids, iter0=done, randomness=randomness,
                tables=sh.tables, store_cr=store_cr, chunk=n,
                warm_ns=warm_ns, drift_max=drift_max, graph=overlap,
                graphs=graphs)
        if engine == "complex":
            return gibbs.run_chain(
                sh.ops, sh.ps, prior_host, n, seed=seed, sids=sh.sids,
                iter0=done, randomness=_complex_randomness(
                    randomness, done, n, sh.device),
                map_estimate=map_estimate, jitter=jitter, store_cr=store_cr,
                graph=overlap, graphs=graphs)
        rnd = _chunk_randomness(randomness, done, n, sh.device, sh.dims)
        if engine == "mega":
            return mega.run_chain_mega(
                sh.ops, sh.dims, sh.ps, sh.bins, n, sh.tables.tlog,
                sh.tables.q, seed=seed, sids=sh.sids, iter0=done,
                randomness=rnd, store_cr=store_cr, graph=overlap,
                graphs=graphs)
        return rgibbs.run_chain(
            sh.ops, sh.ps, sh.bins, n, seed=seed, sids=sh.sids, iter0=done,
            randomness=rnd, map_estimate=map_estimate, jitter=jitter,
            store_cr=store_cr, solver=solver)

    # --- resume ------------------------------------------------------------
    start_iter = 0
    prefix = None
    n_real = len(meta)
    if resume and run_dir is not None:
        ck = hio.load_checkpoint(run_dir, tag=ck_tag)
        if ck is not None:
            consistent = (
                ck["ps"].shape == (n_real, nfreqs)
                and ck["extra"].get("engine", engine) == engine
                and ck["extra"].get("nchains", nchains) == nchains)
            if consistent:
                prefix = _load_prefix(jobs, meta, nchains, ck["iteration"],
                                      store_cr)
            if prefix is not None:
                start_iter = ck["iteration"]
                for sh in shards:
                    sh.ps = sh.to_state(ck["ps"][sh.rows.start:
                                                 sh.rows.stop])
                if verbose:
                    print(f"resuming from iteration {start_iter}")
            elif verbose:
                print("checkpoint inconsistent with this run's "
                      "jobs/outputs; starting fresh")

    # --- chunked chain with host flushes -----------------------------------
    host_chunks = []
    writer = AsyncNpyWriter() if jobs[0].out_dir is not None else None
    native = writer is not None and writer.is_native
    split = dict(write=0.0, flush=0.0, pool_wait=0.0, pool=0.0)
    ckpt_every = (max(1, -(-checkpoint_niter // write_niter))
                  if checkpoint_niter > 0 else 1)
    n_chunks = 0
    # per-(baseline, chain) write seconds (the reference gathers them,
    # run-hydra-pspec.py:554-557): the host's own, plus the pool's seconds
    # of each flush attributed to rows by the bytes each submitted
    row_write_sec = [0.0] * n_real

    def process(tickets, done_ck):
        """Fetch one chunk from every shard, flush every row's files, drain
        the pool, then checkpoint at that chunk's state and iteration."""
        nonlocal n_chunks
        hc, state = _join_rows([sh.fetch.finish(t, store_cr)
                                for sh, t in zip(shards, tickets)])
        host_chunks.append(hc)
        n_chunks += 1
        if verbose:
            print(f"iter {done_ck}/{niter}  chisq={float(np.mean(hc.chisq)):.4f}"
                  f"  ln_post={float(np.mean(hc.ln_post[-1])):.1f}")
        if writer is None:
            return
        t0 = time.perf_counter()
        io0 = writer.write_seconds()
        row_bytes = [0] * n_real
        with record_function("hydra:flush"):
            _flush(jobs, meta, host_chunks, nchains, store_cr, nfreqs, prefix,
                   writer=writer, row_sec=row_write_sec, row_bytes=row_bytes)
        t1 = time.perf_counter()
        # durability: every sample file on disk before the checkpoint
        # records ``done_ck``
        with record_function("hydra:pool_wait"):
            failed = writer.wait()
        t2 = time.perf_counter()
        if failed:
            raise IOError(f"{failed} asynchronous sample writes failed")
        pool_sec = writer.write_seconds() - io0
        total = sum(row_bytes)
        if pool_sec > 0 and total > 0:
            for i, b in enumerate(row_bytes):
                row_write_sec[i] += pool_sec * b / total
        if checkpoint and run_dir is not None and (
                n_chunks % ckpt_every == 0 or done_ck >= niter):
            hio.save_checkpoint(
                run_dir, iteration=done_ck, ps=state[:, :nfreqs],
                key_data=np.asarray([seed], dtype=np.int64),
                extra={"niter": niter, "engine": engine,
                       "nchains": nchains}, tag=ck_tag)
        split["flush"] += t1 - t0
        split["pool_wait"] += t2 - t1
        split["write"] += time.perf_counter() - t0

    n_total = max(1, -(-(niter - start_iter) // write_niter))
    profile_chunk = None if profile_dir is None else min(1, n_total - 1)
    idx = 0
    pending = None
    t0_proc = time.perf_counter()
    done = start_iter
    try:
        while done < niter:
            n = min(write_niter, niter - done)
            prof = _profile_start(devices) if idx == profile_chunk else None
            tickets = []
            for sh in shards:   # chunk idx on every shard, then chunk idx-1
                with _on(sh.device):
                    sh.fetch.reuse(idx)
                    with record_function("hydra:chunk"):
                        # the graphs of a key are captured in both slots
                        # unless no later chunk of this size follows
                        sh.ps, samples = run_chunk(
                            sh, n, done,
                            sh.slots.cache(idx, ahead=niter - done - n >= n))
                    tickets.append(sh.fetch.start(idx, samples, sh.ps,
                                                  store_cr))
                    del samples
            done += n
            if pending is not None:
                process(*pending)   # chunk idx - 1, while chunk idx runs
            pending = (tickets, done)
            if not overlap:
                process(*pending)
                pending = None
            if prof is not None:
                _profile_stop(prof, devices, profile_dir, idx)
            idx += 1
        if pending is not None:
            process(*pending)
    finally:
        if writer is not None:
            split["pool"] = writer.write_seconds()
            writer.close()
    t_process = time.perf_counter() - t0_proc

    results = _collect(jobs, meta, host_chunks, nchains, store_cr, nfreqs,
                       row_write_sec, prefix)
    fetch = [sh.fetch.stats() for sh in shards]
    timings = {
        "process": t_process,
        "scatter": t_scatter,
        "niter": niter,
        "start_iter": start_iter,
        "batch": n_real,
        "engine": engine,
        "device": ", ".join(str(sh.device) for sh in shards),
        **split,
        "is_native": native,
        "overlap": overlap,
        **{k: sum(f[k] for f in fetch) for k in fetch[0]},
        "graph_pool_bytes": [sum(g.pool_bytes for sh in shards
                                 for g in sh.slots.caches[i].values())
                             for i in range(2)],
    }
    return results, timings


class _Shard:
    """One device's contiguous block ``rows`` of the (baseline x chain)
    rows on the plain path, on every engine: its chain operators (built
    from ``ops_rows``, the host operators of its rows), bandpower state,
    stream ids, prior bins, chunk graphs in two slots and fetch."""

    def __init__(self, engine, ops_rows, rows, ps_host, sid_host, prior_host,
                 device, overlap):
        self.rows, self.device = rows, device
        self.dims = self.tables = None
        if engine == "complex":
            self.ops = gcr.to_device(gcr.stack_chain_operators(ops_rows),
                                     device)
            self.to_state = lambda ps: torch.as_tensor(
                np.asarray(ps, np.float64)).to(device)
        elif engine == "real":
            self.ops = rgibbs.to_device(
                rgibbs.stack_chain_operators(ops_rows), device)
            self.to_state = lambda ps: torch.as_tensor(
                np.asarray(ps, np.float32)).to(device)
        else:
            self.ops, dims = mega.from_chain_operators(
                rgibbs.stack_chain_operators(ops_rows), device)
            self.dims = dims
            self.tables = megachain.make_chain_tables(self.ops, device)
            # no reference back to the shard: a cycle would hold its
            # graphs' memory until the collector's next pass
            self.to_state = lambda ps: mega.pad_ps(ps, dims, device)
        block = slice(rows.start, rows.stop)
        self.ps = self.to_state(ps_host[block])
        self.bins = rb.prior_bins(rb.bounded_bins(prior_host), device)
        self.sids = torch.as_tensor(sid_host[block]).to(device)
        self.slots = GraphSlots(2)   # its chunk graphs (card, Philox streams)
        self.fetch = _Fetch(device, pinned=overlap)


def _join_rows(parts):
    """The shards' ``(_HostSample, state)`` of one chunk joined in row
    order (samples on axis 1, the state on axis 0)."""
    if len(parts) == 1:
        return parts[0]
    cat = lambda xs, axis: (None if xs[0] is None
                            else np.concatenate(xs, axis=axis))
    hs = [h for h, _ in parts]
    return (_HostSample(*(cat([getattr(h, k) for h in hs], 1)
                          for k in _HostSample.__slots__)),
            cat([s for _, s in parts], 0))


def _per_row(ps, G):
    """(Bc, n) chain states -> (Bc*G, n), each repeated over its G rows."""
    return ps[:, None].expand(-1, G, -1).reshape(-1, ps.shape[1])


class _TflagsShard:
    """One device's contiguous block ``rows`` of a flag signature's
    (baseline x chain) rows: its chunk runner, state layout and state
    (see :func:`_tflags_megachain`)."""

    def __init__(self, rows, device, built, ps_host):
        self.rows, self.device = rows, device
        self.run, self.to_state, self.chain_ps = built
        self.ps = self.to_state(ps_host[rows.start:rows.stop])


def _run_baselines_tflags(jobs, ps_prior, niter, *, devices, seed, nchains,
                          write_niter, store_cr, engine, warm_ns, drift_max,
                          checkpoint, resume, run_dir, gids, ck_tag,
                          randomness, verbose, map_estimate, jitter, solver):
    """The grouped time-flags path, one flag signature after another
    (``runner.py:775-1063`` of the JAX package), on the megachain or the
    real engine, each signature's rows split over ``devices`` in
    contiguous blocks of whole chains (:func:`dist.shard_rows`), each
    block run on its device and the blocks joined in row order before the
    flush and the checkpoint; on the complex engine one baseline after
    another (``runner.py:1120-1199``) on the first device. Each signature
    has its own checkpoint tag ``-tf{s}`` followed by the process's
    ``ck_tag``; it holds the joined state, so a run checkpointed over some
    devices resumes over any."""
    nbl = len(jobs)
    flags_of = [np.zeros(j.d.shape, dtype=bool) if j.flags_tf is None
                else np.asarray(j.flags_tf, dtype=bool) for j in jobs]
    sig_members = {}
    for ib, f in enumerate(flags_of):
        key = ib if engine == "complex" else (f.shape, f.tobytes())
        sig_members.setdefault(key, []).append(ib)
    if run_dir is None and jobs[0].out_dir is not None:
        run_dir = Path(jobs[0].out_dir).parent
    prior_host = np.asarray(ps_prior, dtype=np.float64)
    results_by_row = {}
    start_iters = []
    used = []
    write_time = t_build = t_process = 0.0
    for si, ibs in enumerate(sig_members.values()):
        meta = [(ib, ic) for ib in ibs for ic in range(nchains)]
        nfreqs = jobs[ibs[0]].d.shape[-1]

        # --- build: per-(baseline, group) operators, stacked over chains --
        t0 = time.perf_counter()
        sid_host = np.asarray([gids[ib] * nchains + ic for ib, ic in meta],
                              dtype=np.int64)
        ps_host = np.stack([_initial_ps_host(jobs[ib].S_initial, nfreqs)
                            for ib, _ in meta])
        job, per_bl = jobs[ibs[0]], None
        if engine == "complex":
            blocks = [(range(len(meta)), devices[0])]
        else:
            blocks = [(rows, dev) for dev, rows in zip(
                devices, shard_rows(len(meta), len(devices))) if len(rows)]
            per_bl = {ib: tflags.build_grouped_operators_real(
                jobs[ib].d, flags_of[ib], jobs[ib].fgmodes, jobs[ib].Ninv)
                for ib in ibs}
        shards = []
        for rows, dev in blocks:
            sids = sid_host[rows.start:rows.stop]
            with _on(dev):
                if engine == "complex":
                    groups = tflags.build_grouped_operators(
                        job.d, flags_of[ibs[0]], job.fgmodes, job.Ninv,
                        device=dev)
                    built = _tflags_complex(
                        groups, sids, dev, seed, store_cr, randomness,
                        map_estimate, jitter, prior_host)
                else:
                    groups = _stacked_groups_real(
                        per_bl, [meta[r] for r in rows])
                    if engine == "real":
                        built = _tflags_real(
                            groups, sids, dev, seed, store_cr, randomness,
                            map_estimate, jitter, solver, rb.prior_bins(
                                rb.bounded_bins(prior_host), dev))
                    else:
                        built = _tflags_megachain(
                            groups, sids, dev, seed, store_cr, randomness,
                            warm_ns, drift_max, prior_host)
                shards.append(_TflagsShard(rows, dev, built, ps_host))
            del groups, built
        del per_bl
        _sync([sh.device for sh in shards])
        if len(shards) > len(used):
            used = [sh.device for sh in shards]
        t_build += time.perf_counter() - t0

        # --- resume: each signature carries its own checkpoint -----------
        tag = f"-tf{si}{ck_tag}"
        start_iter = 0
        prefix = None
        if resume and run_dir is not None:
            ck = hio.load_checkpoint(run_dir, tag=tag)
            if ck is not None and (
                    ck["ps"].shape == (len(meta), nfreqs)
                    and ck["extra"].get("engine", engine) == engine
                    and ck["extra"].get("nchains", nchains) == nchains):
                prefix = _load_prefix(jobs, meta, nchains, ck["iteration"],
                                      store_cr)
                if prefix is not None:
                    start_iter = ck["iteration"]
                    for sh in shards:
                        with _on(sh.device):
                            sh.ps = sh.to_state(
                                ck["ps"][sh.rows.start:sh.rows.stop])
                    if verbose:
                        print(f"[tflags] resuming signature {si} from "
                              f"iteration {start_iter}")
        start_iters.append(start_iter)

        # --- chunked chains with host flushes ------------------------------
        host_chunks = []
        row_write_sec = [0.0] * len(meta)
        t0 = time.perf_counter()
        done = start_iter
        while done < niter:
            n = min(write_niter, niter - done)
            samples = []
            for sh in shards:   # the chunk on every shard, then the fetches
                with _on(sh.device):
                    sh.ps, out = sh.run(sh.ps, n, done)
                samples.append(out)
                del out
            host_chunks.append(_join_rows(
                [(_to_host(x, store_cr), None) for x in samples])[0])
            del samples
            done += n
            if verbose:
                print(f"[tflags x{len(ibs)} baselines] iter {done}/{niter}"
                      f"  chisq={float(np.mean(host_chunks[-1].chisq)):.4f}")
            if jobs[0].out_dir is not None:
                tw = time.perf_counter()
                _flush(jobs, meta, host_chunks, nchains, store_cr, nfreqs,
                       prefix, row_sec=row_write_sec)
                if checkpoint and run_dir is not None:
                    hio.save_checkpoint(
                        run_dir, iteration=done,
                        ps=np.concatenate([
                            sh.chain_ps(sh.ps)[:, :nfreqs].cpu().numpy()
                            for sh in shards]),
                        key_data=np.asarray([seed], dtype=np.int64),
                        extra={"niter": niter, "engine": engine,
                               "nchains": nchains, "tflags": True},
                        tag=tag)
                write_time += time.perf_counter() - tw
        t_process += time.perf_counter() - t0
        rows = _collect(jobs, meta, host_chunks, nchains, store_cr, nfreqs,
                        row_write_sec, prefix)
        results_by_row.update(zip(meta, rows))
        del host_chunks, shards

    results = [results_by_row[(ib, ic)]
               for ib in range(nbl) for ic in range(nchains)]
    timings = {
        "process": t_process,
        "write": write_time,
        "scatter": t_build,
        "niter": niter,
        "start_iter": min(start_iters),
        "batch": nbl * nchains,
        "engine": engine,
        "device": ", ".join(str(d) for d in used),
    }
    return results, timings


def _stacked_groups_real(per_bl, meta):
    """A signature's per-group real operators (``per_bl``: each baseline's
    groups), stacked over the (baseline, chain) rows ``meta``."""
    first = next(iter(per_bl.values()))
    return [tflags.TimeGroupReal(
                ops=rgibbs.stack_chain_operators(
                    [per_bl[ib][g].ops for ib, _ in meta]),
                idx=first[g].idx)
            for g in range(len(first))]


def _tflags_complex(groups, sid_host, device, seed, store_cr, randomness,
                    map_estimate, jitter, prior_host):
    """One baseline's chains on the complex engine's grouped step, the
    groups' operators shared by the chains. Returns as
    :func:`_tflags_megachain` (one state row per chain)."""
    sids_t = torch.from_numpy(sid_host.astype(np.int32)).to(device)

    def run(ps, n, done):
        return tflags.run_chain_tflags(
            groups, ps, prior_host, n, seed=seed, sids=sids_t, iter0=done,
            randomness=_complex_randomness(randomness, done, n, device,
                                           sids=sid_host),
            map_estimate=map_estimate, jitter=jitter, store_cr=store_cr)

    return (run,
            lambda ps: torch.as_tensor(np.asarray(ps, np.float64)).to(device),
            lambda ps: ps)


def _tflags_megachain(groups, sid_host, device, seed, store_cr, randomness,
                      warm_ns, drift_max, prior_host):
    """A signature on the grouped megachain mode: chain-major (chain, time
    group) rows, row streams ``sid*G_key + g`` and chain streams ``sid``
    (:func:`philox.grouped_stream_ids`).
    Returns ``(run(ps, n, done), to_state(host ps), chain_ps(state))``:
    the chunk runner, and the state layout (one row per (chain, group))."""
    setup = megachain.build_tflags_mega_setup(groups, device)
    G = len(setup.group_times)
    sids_row, sidc_rows = philox.grouped_stream_ids(sid_host, G)
    sids_t = torch.from_numpy(sids_row).to(device)
    sidc_t = torch.from_numpy(sidc_rows).to(device)
    tables = megachain.make_chain_tables(setup.mops, device)
    rnd = None
    if randomness is not None:
        rnd = (lambda it, k: randomness(it, k, sids=sids_row, sidc=sidc_rows,
                                        group=G))
    graphs = {}   # this signature's chunk graphs

    def run(ps, n, done):
        return megachain.run_chain_megachain(
            setup.mops, setup.dims, ps, prior_host, n, seed=seed,
            sids=sids_t, iter0=done, randomness=rnd, tables=tables,
            store_cr=store_cr, chunk=n, warm_ns=warm_ns,
            drift_max=drift_max, group_times=setup.group_times,
            sidc=sidc_t, group_idx=setup.group_idx, graphs=graphs)

    return (run, lambda ps: _per_row(mega.pad_ps(ps, setup.dims, device), G),
            lambda ps: ps[::G])


def _tflags_real(groups, sid_host, device, seed, store_cr, randomness,
                 map_estimate, jitter, solver, bins):
    """A signature on the real engine: every time group's operators stacked
    over the chains, the pooled draw through the table at the total time
    count (``runner.py:939-983`` of the JAX package). Returns as
    :func:`_tflags_megachain` (one state row per chain)."""
    ntimes_total = sum(int(np.asarray(g.idx).size) for g in groups)
    igt = make_invgamma_table(ntimes_total)
    tlog = torch.from_numpy(np.asarray(igt.log_y)).to(device)
    q = torch.from_numpy(np.asarray(igt.q)).to(device)
    gdev = tflags.to_device(groups, device)
    sids_t = torch.from_numpy(sid_host.astype(np.int32)).to(device)

    def run(ps, n, done):
        rnd = _chunk_randomness(randomness, done, n, device, sids=sid_host)
        return tflags.run_chain_tflags_real(
            gdev, ps, bins, n, tlog, q, seed=seed, sids=sids_t, iter0=done,
            randomness=rnd, map_estimate=map_estimate, jitter=jitter,
            store_cr=store_cr, solver=solver)

    return (run,
            lambda ps: torch.as_tensor(np.asarray(ps, np.float32)).to(device),
            lambda ps: ps)


class _HostSample:
    __slots__ = ("signal_cr", "ps", "fg_amps", "chisq", "ln_post")

    def __init__(self, signal_cr, ps, fg_amps, chisq, ln_post):
        self.signal_cr = signal_cr
        self.ps = ps
        self.fg_amps = fg_amps
        self.chisq = chisq
        self.ln_post = ln_post


def _sample_fields(samples, store_cr):
    """A chunk's sample tensors by name (iterations on axis 0, batch on
    axis 1); the per-time fields only with ``store_cr``."""
    out = {"ps": samples.ps, "chisq": samples.chisq,
           "ln_post": samples.ln_post}
    if store_cr:
        out.update(signal_cr=samples.signal_cr, fg_amps=samples.fg_amps)
    return out


def _host_sample(h: dict) -> _HostSample:
    return _HostSample(h.get("signal_cr"), h["ps"], h.get("fg_amps"),
                       h["chisq"], h["ln_post"])


def _numpy(fields: dict) -> dict:
    """Tensors -> numpy, by a synchronous copy off the device."""
    return {k: v.contiguous().cpu().numpy() for k, v in fields.items()}


def _to_host(samples, store_cr):
    return _host_sample(_numpy(_sample_fields(samples, store_cr)))


STAGING_PIECE_BYTES = 64 << 20   # one of the two pinned staging buffers


class _Fetch:
    """Each chunk's samples and end state on their way to the host.

    ``pinned`` on the card: :meth:`start` records an event after the chunk
    on the compute stream; on a copy stream that waits on it, the strided
    sample views are made contiguous on the device. :meth:`finish` streams
    those bytes through two pinned staging buffers of
    :data:`STAGING_PIECE_BYTES`, reused in turn: ``non_blocking`` copies
    on the copy stream, the host waiting on each piece's event only and
    copying the piece into the kept numpy arrays while the next piece
    crosses. So the pinned memory stays 2 x 64 MiB however large a chunk
    or long a run. :meth:`finish` then records the chunk's last copy, on
    which :meth:`reuse` makes the compute stream wait before the chunk
    that replays the same graph slot. A ticket holds the device tensors
    until :meth:`finish`, so no copy reads freed memory. Otherwise (the
    serial loop, CPU tensors) :meth:`finish` copies synchronously."""

    def __init__(self, device, pinned: bool, nslots: int = 2):
        self.device = device
        self.pinned = pinned and device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.pinned else None
        self.ring = None
        self.copied = [None] * nslots
        self.seconds = {"fetch_wait": 0.0, "staging": 0.0, "pin_alloc": 0.0}

    def reuse(self, chunk: int):
        ev = self.copied[chunk % len(self.copied)]
        if ev is not None:
            torch.cuda.current_stream(self.device).wait_event(ev)

    def start(self, chunk: int, samples, state, store_cr):
        fields = dict(_sample_fields(samples, store_cr), state=state)
        if not self.pinned:
            return chunk, fields, None
        ran = torch.cuda.Event()
        ran.record(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream), record_function("hydra:pack"):
            self.stream.wait_event(ran)
            flat = {k: t.contiguous().view(-1).view(torch.uint8)
                    for k, t in fields.items()}
        return chunk, fields, flat

    def _issue(self, slot, src):
        """Copy ``src`` (device bytes) into staging buffer ``slot``; its
        event."""
        with torch.cuda.stream(self.stream):
            self.ring[slot][:src.numel()].copy_(src, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        return ev

    def finish(self, ticket, store_cr):
        """``(_HostSample, state as numpy)`` of a ticket of :meth:`start`."""
        chunk, fields, flat = ticket
        t0 = time.perf_counter()
        if flat is None:
            h = _numpy(fields)
            self.seconds["fetch_wait"] += time.perf_counter() - t0
            return _host_sample(h), h["state"]
        if self.ring is None:
            self.ring = [torch.empty(STAGING_PIECE_BYTES, dtype=torch.uint8,
                                     pin_memory=True) for _ in range(2)]
            self.seconds["pin_alloc"] += time.perf_counter() - t0
        h = {k: np.empty(t.shape, np.dtype(str(t.dtype).split(".")[1]))
             for k, t in fields.items()}
        pieces = [(k, off) for k, b in flat.items()
                  for off in range(0, b.numel(), STAGING_PIECE_BYTES)]
        src = lambda j: flat[pieces[j][0]][
            pieces[j][1]:pieces[j][1] + STAGING_PIECE_BYTES]
        events = [self._issue(j, src(j)) for j in range(min(2, len(pieces)))]
        for j, (k, off) in enumerate(pieces):
            t1 = time.perf_counter()
            with record_function("hydra:fetch_wait"):
                events[j % 2].synchronize()
            t2 = time.perf_counter()
            with record_function("hydra:staging"):
                piece = src(j)
                dst = h[k].reshape(-1).view(np.uint8)[off:off + piece.numel()]
                # torch's CPU copy runs on its intra-op threads
                torch.from_numpy(dst).copy_(self.ring[j % 2][:piece.numel()])
            if j + 2 < len(pieces):
                events[j % 2] = self._issue(j % 2, src(j + 2))
            self.seconds["fetch_wait"] += t2 - t1
            self.seconds["staging"] += time.perf_counter() - t2
        done = torch.cuda.Event()
        done.record(self.stream)
        self.copied[chunk % len(self.copied)] = done
        return _host_sample(h), h["state"]

    def stats(self) -> dict:
        return dict(self.seconds, pinned_bytes=0 if self.ring is None else
                    sum(b.numel() for b in self.ring))


def _profile_start(devices):
    """A ``torch.profiler`` window (CPU, and CUDA on the card) from idle
    devices."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if any(d.type == "cuda" for d in devices):
        acts.append(ProfilerActivity.CUDA)
    _sync(devices)
    prof = profile(activities=acts)
    prof.start()
    return prof


def _profile_stop(prof, devices, profile_dir, chunk: int):
    """Close the window once the devices are idle; write its Chrome
    trace."""
    _sync(devices)
    prof.stop()
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / f"chunk-{chunk}.trace.json"))


def _chain_dir(out_dir, chain, nchains):
    d = Path(out_dir)
    if nchains > 1:
        d = d / f"chain-{chain}"
    return d


def _slice_batch(host_chunks, idx, store_cr, prefix=None):
    """Per-(baseline, chain) arrays with iterations on axis 0; ``prefix``
    (resume) holds this chain's pre-checkpoint samples read from disk."""
    pre = prefix or {}

    def cat(key, chunk_arrs):
        parts = ([pre[key]] if key in pre else []) + chunk_arrs
        return np.concatenate(parts)

    take = lambda a: None if a is None else np.take(a, idx, axis=1)
    ps = cat("signal_ps", [take(c.ps) for c in host_chunks])
    lnp = cat("ln_post", [np.atleast_1d(take(c.ln_post))
                          for c in host_chunks])
    if store_cr:
        cr = cat("signal_cr", [take(c.signal_cr) for c in host_chunks])
        fga = cat("fg_amps", [take(c.fg_amps) for c in host_chunks])
        chi = cat("chisq", [take(c.chisq) for c in host_chunks])
    else:
        cr = fga = None
        chi = cat("chisq", [np.atleast_1d(take(c.chisq))
                            for c in host_chunks])
    return ps, lnp, cr, fga, chi


def _load_prefix(jobs, meta, nchains, start_iter, store_cr):
    """Each chain's first ``start_iter`` samples read back for resume, or
    None when any chain's files are missing or short."""
    if start_iter == 0:
        return None
    keys = ["signal_ps", "ln_post"] + (
        ["signal_cr", "fg_amps", "chisq"] if store_cr else ["chisq"])
    prefix = []
    for ib, ic in meta:
        if jobs[ib].out_dir is None:
            return None
        s = hio.load_samples(_chain_dir(jobs[ib].out_dir, ic, nchains))
        if any(k not in s or s[k].shape[0] < start_iter for k in keys):
            return None
        prefix.append({k: s[k][:start_iter] for k in keys})
    return prefix


def _final_S(ps_last, nfreqs):
    i = np.arange(nfreqs) - nfreqs // 2
    F = np.exp(-2j * np.pi * np.outer(i, i) / nfreqs)
    return F.conj().T @ np.diag(ps_last / nfreqs**2).astype(complex) @ F


def _flush(jobs, meta, host_chunks, nchains, store_cr, nfreqs, prefix=None,
           writer=None, row_sec=None, row_bytes=None):
    """Write every row's six sample files (whole chain so far), through
    ``writer`` (an :class:`AsyncNpyWriter`) or ``np.save``. ``row_sec`` /
    ``row_bytes`` (optional lists aligned with ``meta``) add each row's
    host seconds and the bytes it submitted."""
    for bidx, (ib, ic) in enumerate(meta):
        job = jobs[ib]
        if job.out_dir is None:
            continue
        t0 = time.perf_counter()
        ps, lnp, cr, fga, chi = _slice_batch(
            host_chunks, bidx, store_cr, prefix[bidx] if prefix else None)
        arrays = (cr if cr is not None else np.zeros(0),
                  _final_S(ps[-1], nfreqs), ps,
                  fga if fga is not None else np.zeros(0), chi, lnp)
        hio.write_numpy_files(_chain_dir(job.out_dir, ic, nchains), *arrays,
                              writer=writer)
        if row_sec is not None:
            row_sec[bidx] += time.perf_counter() - t0
        if row_bytes is not None:
            row_bytes[bidx] += sum(a.nbytes for a in arrays)


def _collect(jobs, meta, host_chunks, nchains, store_cr, nfreqs,
             row_write_sec, prefix=None):
    results = []
    for bidx, (ib, ic) in enumerate(meta):
        job = jobs[ib]
        ps, lnp, cr, fga, chi = _slice_batch(
            host_chunks, bidx, store_cr, prefix[bidx] if prefix else None)
        results.append(RunResult(
            antpair=job.antpair, chain=ic, signal_ps=ps, ln_post=lnp,
            chisq=chi, signal_cr=cr, fg_amps=fga,
            signal_S=_final_S(ps[-1], nfreqs),
            out_dir=(None if job.out_dir is None
                     else _chain_dir(job.out_dir, ic, nchains)),
            write_time=row_write_sec[bidx]))
    return results


def gelman_rubin(ps_chains: np.ndarray) -> np.ndarray:
    """Split-R-hat over chains: (Nchains, Niter, Nfreqs) -> (Nfreqs,)."""
    c, n, k = ps_chains.shape
    half = n // 2
    splits = ps_chains[:, :half], ps_chains[:, half: 2 * half]
    x = np.concatenate(splits, axis=0)
    nn = x.shape[1]
    chain_means = x.mean(axis=1)
    chain_vars = x.var(axis=1, ddof=1)
    B = nn * chain_means.var(axis=0, ddof=1)
    W = chain_vars.mean(axis=0)
    var_hat = (nn - 1) / nn * W + B / nn
    return np.sqrt(var_hat / np.maximum(W, 1e-300))
