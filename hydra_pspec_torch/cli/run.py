"""The port's command line (the counterpart of ``hydra_pspec_tpu/cli/
run.py``): the reference's run-hydra-pspec.py YAML keys and flags, its
per-baseline file conventions, output layout and provenance artifacts, on
the card.

Usage:
    python -m hydra_pspec_torch.cli.run --config config.yaml [flags]
    run-hydra-pspec-torch --config config.yaml [flags]

In one process the chains run on every local card: :func:`main` with its
default ``device="cuda"`` splits the rows over the
``torch.cuda.device_count()`` cards, and ``device="cuda:1"`` keeps one.
Over N processes (one per device, or several on one card), start each
with ``--num_processes N --process_id i --coordinator host:port`` (process
0's address, any free port): each reads and samples its block of
baselines (the reference's block rule) on ``cuda:{LOCAL_RANK}`` when a
launcher sets ``LOCAL_RANK``, else ``cuda:{i % device_count}``; the group
runs over gloo (``parallel/dist.py``), and process 0 writes the run's
artifacts.

uvh5 input is read with h5py and a YAML config with pyyaml, each imported
where it is read: :func:`run_jobs`, everything after the load, needs
neither. The port's policy: ``precision`` ``auto`` or ``x32`` runs the
float32 engines, ``x64`` the complex float64 engine (complex128 on the
card, the correctness tier); ``engine: auto`` is megachain
(``runner.select_engine``), and ``runner.route_engine`` sends what it does
not cover to the mega or real engine.
"""
import argparse
import sys
import time
import typing
from dataclasses import fields
from pathlib import Path

import numpy as np

from ..parallel import dist
from ..parallel.partition import local_indices
from ..runner import BaselineJob, gelman_rubin, run_baselines
from ..utils import provenance
from ..utils import uvh5 as uv
from ..utils.config import RunConfig, resolve_per_baseline
from ..utils.io import add_mtime_to_filepath


def build_parser():
    p = argparse.ArgumentParser(
        description="hydra-pspec on the GPU (config-compatible driver).")
    p.add_argument("--config", type=str, help="YAML config (reference format)")
    p.add_argument("file_paths", nargs="*", help="uvh5 visibility file(s)")
    hints = typing.get_type_hints(RunConfig)
    for f in fields(RunConfig):
        if f.name == "file_paths":
            continue
        arg = f"--{f.name}"
        # the resolved annotation decides the type; Optional[T] is T
        t = hints.get(f.name, str)
        if typing.get_origin(t) is typing.Union:
            args_t = [a for a in typing.get_args(t) if a is not type(None)]
            t = args_t[0] if len(args_t) == 1 else str
        if t is bool:
            # --X / --no-X, so knobs that default to True can be turned off
            p.add_argument(arg, action=argparse.BooleanOptionalAction,
                           default=None)
        elif t is int:
            p.add_argument(arg, type=int, default=None)
        elif t is float:
            p.add_argument(arg, type=float, default=None)
        else:
            p.add_argument(arg, type=str, default=None)
    p.add_argument("--num_processes", type=int, default=1)
    p.add_argument("--process_id", type=int, default=0)
    p.add_argument("--coordinator", type=str, default=None)
    return p


def load_config(argv=None):
    args = build_parser().parse_args(argv)
    overrides = {
        k: v for k, v in vars(args).items()
        if k not in ("config", "num_processes", "process_id", "coordinator")
        and v not in (None, [])
    }
    if args.config:
        cfg = RunConfig.from_yaml(args.config, **overrides)
    else:
        cfg = RunConfig.from_dict(overrides)
    return cfg, args


def check_supported(cfg: RunConfig):
    """The port's policy (module docstring): raise for what it does not
    run."""
    if cfg.precision not in ("auto", "x32", "x64"):
        raise ValueError(f"unknown precision {cfg.precision!r}")


def engine_of(cfg: RunConfig) -> str:
    """The engine the run asks for: ``precision x64`` turns ``engine:
    auto`` into the complex float64 engine (``cli/run.py:82-94`` of the
    JAX package: x64 makes ``select_engine`` pick it); an explicit
    engine is taken as given."""
    if cfg.precision == "x64" and cfg.engine == "auto":
        return "complex"
    return cfg.engine


def legendre_fgmodes(nfreqs: int, nmodes: int) -> np.ndarray:
    """Legendre-polynomial foreground basis (reference
    run-hydra-pspec.py:456-460)."""
    from numpy.polynomial import legendre

    x = np.linspace(-1.0, 1.0, nfreqs)
    cols = []
    for i in range(nmodes):
        c = np.zeros(i + 1)
        c[i] = 1.0
        cols.append(legendre.legval(x, c))
    return np.stack(cols, axis=1)


def prepare_jobs(cfg: RunConfig, out_dir: Path, process_id=0,
                 num_processes=1):
    """This process's baselines only, read from the uvh5 files (the
    reference loads everything on rank 0, run-hydra-pspec.py:290-477),
    with the per-baseline auxiliary inputs, the noise injection and the
    optional per-time flags. Returns ``(jobs, nfreqs, n_baselines,
    load seconds, global indices of the jobs)``."""
    antpairs = uv.parse_ant_str(cfg.ant_str)
    t0 = time.perf_counter()
    all_bls = []
    for fp in sorted(cfg.file_paths):
        bls, _ = uv.read_uvh5(fp, antpairs=antpairs,
                              freq_range=cfg.freq_range)
        all_bls.extend(bls)
    if not all_bls:
        raise SystemExit("No baselines found in input file(s).")
    nfreqs = all_bls[0].vis.shape[1]
    if len(all_bls) < num_processes:
        # the reference calls comm.Abort (run-hydra-pspec.py:273-277)
        raise ValueError(f"Number of baselines ({len(all_bls)}) should be "
                         f">= number of ranks ({num_processes})")

    mine = list(local_indices(len(all_bls), process_id, num_processes))
    jobs = []
    for i in mine:
        bl = all_bls[i]
        a, b = bl.antpair
        bl_str = f"{a}-{b}"
        d = np.array(bl.vis)

        flags = resolve_per_baseline(cfg.flags, cfg.flags_file, bl_str)
        if flags is None:
            flags = bl.flags
        nsamples = resolve_per_baseline(cfg.nsamples, cfg.nsamples_file,
                                        bl_str)
        noise = resolve_per_baseline(cfg.noise, cfg.noise_file, bl_str)
        if noise is not None:
            noise = np.array(noise)
            if nsamples is not None:
                noise /= np.sqrt(nsamples)
            d = d + noise

        sigcov0 = resolve_per_baseline(cfg.sigcov0, cfg.sigcov0_file, bl_str)
        if sigcov0 is None:
            sigcov0 = np.eye(nfreqs)

        noise_cov = resolve_per_baseline(cfg.noise_cov, cfg.noise_cov_file,
                                         bl_str)
        if noise_cov is not None:
            ninv = np.linalg.inv(noise_cov)
        else:
            ninv = np.eye(nfreqs) / 10.0**2  # reference fallback (:438)

        fgm = resolve_per_baseline(
            cfg.fgmodes, cfg.fgmodes_file, bl_str,
            default_name=f"evecs-{_freq_str(bl.freqs)}.npy")
        if fgm is None:
            fgm = legendre_fgmodes(nfreqs, cfg.Nfgmodes)
        fgm = fgm[:, :cfg.Nfgmodes]

        flags_b = np.asarray(flags, dtype=bool)
        jobs.append(BaselineJob(
            antpair=bl.antpair, d=d, w=uv.collapse_flags_any_time(flags_b),
            fgmodes=fgm, S_initial=sigcov0, Ninv=ninv, out_dir=out_dir / bl_str,
            # opt-in per-time flag patterns (reference FIXME :541)
            flags_tf=flags_b if cfg.time_flags else None))
    t_load = time.perf_counter() - t0
    return jobs, nfreqs, len(all_bls), t_load, mine


def _freq_str(freqs_hz):
    f = np.asarray(freqs_hz) / 1e6
    return f"{f.min():.3f}-{f.max():.3f}MHz"


def build_prior(cfg, nfreqs: int) -> np.ndarray:
    """Prior window around delay 0 (reference run-hydra-pspec.py:504-517).
    ``cfg`` carries ``ps_prior_lo``, ``ps_prior_hi`` and
    ``n_ps_prior_bins``."""
    prior = np.zeros((2, nfreqs))
    if cfg.ps_prior_lo != 0 or cfg.ps_prior_hi != 0:
        sl = slice(nfreqs // 2 - cfg.n_ps_prior_bins,
                   nfreqs // 2 + cfg.n_ps_prior_bins + 1)
        prior[0, sl] = cfg.ps_prior_hi
        prior[1, sl] = cfg.ps_prior_lo
    return prior


def output_dir(cfg: RunConfig, create: bool = True) -> Path:
    """The results directory (reference run-hydra-pspec.py:334-365):
    ``<out_dir>/results-<freqs>-Niter-<N>``, or ``<dirname>`` (with
    ``-map-estimate`` in MAP mode). With ``create`` (process 0 alone), an
    existing one is renamed with its mtime unless ``clobber`` or
    ``resume``, then it is created, with ``git.json``, ``args.json`` and
    the slurm job file."""
    if not cfg.dirname:
        # the default name carries the band: a header-only read
        import h5py

        with h5py.File(sorted(cfg.file_paths)[0], "r") as f:
            fr = np.asarray(f["Header/freq_array"][:]).reshape(-1)
        if cfg.freq_range:
            fr = uv.filter_freqs(cfg.freq_range, fr / 1e6) * 1e6
        dirname = f"results-{_freq_str(fr)}-Niter-{cfg.Niter}"
    else:
        dirname = cfg.dirname + ("-map-estimate" if cfg.map_estimate else "")
    out_dir = Path(cfg.out_dir) / dirname
    if not create:
        return out_dir
    if out_dir.exists() and not cfg.clobber and not cfg.resume:
        add_mtime_to_filepath(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    provenance.write_git_json(out_dir)
    provenance.write_args_json(out_dir, cfg.to_dict())
    provenance.touch_slurm_job_file(out_dir)
    if cfg.verbose:
        print(f"Writing output(s) to {out_dir.absolute()}")
    return out_dir


def run_jobs(cfg: RunConfig, jobs, nfreqs: int, n_baselines: int,
             t_load: float, out_dir: Path, device="cuda", t_start=None,
             global_baseline_ids=None, process_id: int = 0,
             num_processes: int = 1, mesh_devices=None):
    """Everything :func:`main` does after the load: the chains of ``jobs``
    through ``runner.run_baselines`` on ``device``, then ``rhat.json``
    (with more than one chain), ``timings.json`` (the true per-baseline
    write seconds) and ``resources.json`` in ``out_dir``. ``t_start``:
    the ``time.perf_counter()`` the run's total counts from (default: the
    load's start). ``global_baseline_ids``: the jobs' indices among the
    run's ``n_baselines`` (:func:`prepare_jobs` returns them), which key
    their streams. ``process_id`` / ``num_processes``: ``jobs`` is this
    process's block of a run over that many processes, whose group is up
    (``dist.initialize_distributed``): R-hat and write seconds are
    gathered over it, and process 0 alone writes the three files.
    ``mesh_devices``: the devices this process splits its rows over
    (``runner.run_baselines``; default ``device`` alone). Returns
    ``(results, timings)`` of the runner."""
    if t_start is None:
        t_start = time.perf_counter() - t_load
    check_supported(cfg)
    is_rank0 = process_id == 0
    results, timings = run_baselines(
        jobs, build_prior(cfg, nfreqs), cfg.Niter, device=device,
        seed=cfg.seed, nchains=cfg.nchains, write_niter=cfg.write_Niter,
        map_estimate=cfg.map_estimate, store_cr=cfg.store_cr,
        jitter=cfg.jitter, engine=engine_of(cfg), solver=cfg.solver,
        warm_ns=cfg.warm_ns, drift_max=cfg.drift_max,
        checkpoint_niter=cfg.checkpoint_Niter, resume=cfg.resume,
        run_dir=out_dir, process_id=process_id, num_processes=num_processes,
        n_global_baselines=n_baselines, mesh_devices=mesh_devices,
        global_baseline_ids=global_baseline_ids,
        verbose=cfg.verbose and is_rank0, profile_dir=cfg.profile_dir)

    # split-R-hat over chains, per baseline, persisted as rhat.json
    if cfg.nchains > 1:
        local_rhat = {}
        for job in jobs:
            chains = np.stack([r.signal_ps for r in results
                               if r.antpair == job.antpair])
            rhat = gelman_rubin(chains)
            local_rhat[f"{job.antpair[0]}_{job.antpair[1]}"] = rhat
            if cfg.verbose and is_rank0:
                print(f"baseline {job.antpair}: split-Rhat max "
                      f"{np.nanmax(rhat):.3f} median "
                      f"{np.nanmedian(rhat):.3f}")
        all_rhat = dist.gather_per_baseline(local_rhat, jobs, num_processes)
        if is_rank0:
            provenance.write_rhat_json(out_dir, all_rhat)

    # the true per-baseline write seconds, summed over its chain dirs
    # (the reference's comm.gather(write_timings), run-hydra-pspec.py:554-557)
    local_wt = {f"{j.antpair[0]}_{j.antpair[1]}": float(sum(
        r.write_time for r in results if r.antpair == j.antpair))
        for j in jobs}
    all_wt = dist.gather_per_baseline(local_wt, jobs, num_processes)
    t_barrier0 = time.perf_counter()
    dist.barrier()
    t_barrier = time.perf_counter() - t_barrier0
    if not is_rank0:
        return results, timings
    write_data = [{"rank": rank,
                   "ant_pairs": [bl for bl, _ in entries],
                   "write_times": [float(np.sum(v)) for _, v in entries]}
                  for rank, entries in enumerate(all_wt)]
    provenance.write_timings_json(
        out_dir, num_ranks=num_processes, num_baselines=n_baselines,
        load_data=t_load, scatter=timings["scatter"],
        process=timings["process"], barrier=t_barrier,
        total=time.perf_counter() - t_start, write_data=write_data)
    provenance.write_resources_json(out_dir)
    if cfg.verbose:
        print(f"done: {n_baselines} baselines x {cfg.nchains} chains x "
              f"{cfg.Niter} iters in {timings['process']:.2f}s "
              f"({n_baselines * cfg.nchains * cfg.Niter / timings['process']:.1f}"
              f" baseline-iters/s)")
    return results, timings


def main(argv=None, device="cuda"):
    """The whole run: configuration, process group, output directory,
    load, chains and artifacts. ``device``: where the chains run (the
    card unless the caller asks for ``"cpu"``): ``"cuda"`` in one process
    is every local card, the rows split over them; with more than one
    process, this process's card; an index keeps that card
    (``dist.local_devices``). Returns 0."""
    t_start = time.perf_counter()
    cfg, args = load_config(argv)
    check_supported(cfg)
    pid, nproc = args.process_id, args.num_processes
    started = dist.initialize_distributed(args.coordinator, nproc, pid)
    try:
        devices = dist.local_devices(device, pid, nproc)
        out_dir = output_dir(cfg, create=pid == 0)
        # no rank writes under a directory that rank 0 is still renaming
        dist.barrier()
        jobs, nfreqs, n_baselines, t_load, gids = prepare_jobs(
            cfg, out_dir, pid, nproc)
        run_jobs(cfg, jobs, nfreqs, n_baselines, t_load, out_dir,
                 device=devices[0], t_start=t_start,
                 global_baseline_ids=gids, process_id=pid,
                 num_processes=nproc,
                 mesh_devices=devices if len(devices) > 1 else None)
    finally:
        if started:
            dist.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
