"""Strong-scaling harness of the port: a sweep over process counts and over
devices in one process, each sweep point a run of the CLI's path
(``cli.run.run_jobs``) in fresh processes, its counterpart in the JAX
package being ``scripts/scaling_test.py`` with
``scripts/scaling_tests/launch_scaling_sweep.sh``.

    python -m hydra_pspec_torch.scripts.scaling_test --out scaling/ \
        [--ranks 1,2,4] [--device_sweep 2,4] [--n 16] [--niter 20] \
        [--device cuda] [--devices cuda:0,cuda:1] [--data scaling-data/]

Each point writes its run under ``OUT/<point>/res/`` (``ranks-N``: N
processes over gloo, each on its card by ``dist.rank_device``;
``devices-D``: one process whose rows are split over the first D entries
of ``--devices``, taken in turn, default every local card) and copies its
``timings.json`` to ``OUT/<point>/`` (one a sweep point, the layout the
reference's plotter reads). The reference's plotter is not part of this
repository, so the harness prints its own table: for each point the
``process`` and ``total`` seconds of rank 0, and the speed-up and the
efficiency (speed-up over the point's process or device count) of each
against ``ranks-1``.

The data are ``--n`` baselines of the synthetic problem
(``validation/synth.py``), made anew by every process, or with ``--data``
the output of ``make_scaling_data`` read through the CLI's loader (h5py).
Every baseline's streams are keyed on its global id, so the scaling oracle
is that every point writes the sample files of ``ranks-1`` bit for bit;
the table says so for each point and the exit code is 1 when one differs.
Every point starts its processes the same way, so the host's float64
products round alike in all (they round by the BLAS's thread count).

``launch_scaling_sweep.sh`` beside this file starts the processes of each
point from the shell instead, then calls ``--table OUT``, which prints the
table of the points already in OUT.
"""
import argparse
import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

from ..validation import synth

REPO = Path(__file__).resolve().parents[2]
REF = "ranks-1"
# the data and run options a worker gets from the sweep
PASSED = ("n", "niter", "write_niter", "nchains", "ntimes", "nfreqs", "seed",
          "data_seed", "device", "devices", "data")


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="./scaling")
    p.add_argument("--ranks", default="1,2",
                   help="comma list of process counts")
    p.add_argument("--device_sweep", default="",
                   help="comma list of device counts in one process")
    p.add_argument("--device", default="cuda",
                   help="cuda (each rank's card) or cpu")
    p.add_argument("--devices", default=None,
                   help="comma list the one-process points split over "
                        "(default: every local card, or cpu)")
    p.add_argument("--n", type=int, default=16, help="baselines")
    p.add_argument("--niter", type=int, default=20)
    p.add_argument("--write_niter", type=int, default=None,
                   help="chunk length (default: niter)")
    p.add_argument("--nchains", type=int, default=1)
    p.add_argument("--ntimes", type=int, default=synth.NT)
    p.add_argument("--nfreqs", type=int, default=synth.NF)
    p.add_argument("--seed", type=int, default=7123689,
                   help="the chains' Philox seed")
    p.add_argument("--data_seed", type=int, default=synth.SEED)
    p.add_argument("--data", default=None,
                   help="a make_scaling_data directory instead of the "
                        "synthetic jobs")
    p.add_argument("--timeout", type=float, default=1800.0,
                   help="seconds a sweep point may take")
    p.add_argument("--table", default=None, metavar="OUT",
                   help="print the table of OUT's points and stop")
    # one process of a sweep point
    p.add_argument("--worker", default=None, metavar="POINT_DIR")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--nranks", type=int, default=1)
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--mesh", type=int, default=1,
                   help="devices of a one-process point")
    return p


def _ints(spec):
    return [int(x) for x in str(spec).split(",") if x.strip()]


def run_config(args, point):
    """The CLI configuration of a sweep point (flags, no YAML): the
    synthetic prior's bounds over its central bins, every chunk
    checkpointed, the run under ``point/res``."""
    from ..utils.config import RunConfig

    prior = synth.make_prior(nf=args.nfreqs)
    raw = dict(Niter=args.niter, write_Niter=args.write_niter or args.niter,
               nchains=args.nchains, seed=args.seed, out_dir=str(point),
               dirname="res", clobber=True, store_cr=True,
               Nfgmodes=synth.NM, n_ps_prior_bins=synth.PRIOR_HALF,
               ps_prior_lo=float(prior[1][prior[1] > 0].min()),
               ps_prior_hi=float(prior[0].max()))
    if args.data:
        aux = str(Path(args.data) / "aux")
        raw.update(file_paths=[str(Path(args.data) / "vis.uvh5")],
                   noise_cov=aux, noise_cov_file="noise-cov.npy",
                   fgmodes=aux, fgmodes_file="fgmodes.npy",
                   sigcov0=aux, sigcov0_file="eor-cov.npy")
    return RunConfig.from_dict(raw)


def point_devices(args):
    """The devices of a one-process point: the first ``--mesh`` entries of
    ``--devices``, taken in turn."""
    import torch

    if args.devices:
        devs = args.devices.split(",")
    elif args.device.startswith("cuda") and torch.cuda.device_count():
        devs = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    else:
        devs = [args.device]
    return [torch.device(devs[i % len(devs)]) for i in range(args.mesh)]


def worker(args):
    """One process of a sweep point: its block of the jobs through
    ``cli.run.run_jobs`` on its device or devices; rank 0 copies the
    point's ``timings.json`` next to its run."""
    from ..cli import run as cli
    from ..parallel import dist
    from ..parallel.partition import local_indices

    t_start = time.perf_counter()
    point = Path(args.worker)
    cfg = run_config(args, point)
    started = dist.initialize_distributed(f"localhost:{args.port}",
                                          args.nranks, args.rank)
    try:
        if args.nranks > 1:
            devices = [dist.rank_device(args.device, args.rank)]
        else:
            devices = point_devices(args)
            devices[0] = dist.rank_device(devices[0], 0)
        out = cli.output_dir(cfg, create=args.rank == 0)
        dist.barrier()
        if cfg.file_paths:
            jobs, nf, nbl, t_load, ids = cli.prepare_jobs(
                cfg, out, args.rank, args.nranks)
        else:
            t0 = time.perf_counter()
            every = synth.make_jobs(args.n, ntimes=args.ntimes,
                                    seed=args.data_seed, nf=args.nfreqs)
            ids = list(local_indices(args.n, args.rank, args.nranks))
            jobs = [dataclasses.replace(
                every[i], out_dir=out / "-".join(map(str, every[i].antpair)))
                for i in ids]
            nf, nbl, t_load = args.nfreqs, args.n, time.perf_counter() - t0
        cli.run_jobs(cfg, jobs, nf, nbl, t_load, out, device=devices[0],
                     t_start=t_start, global_baseline_ids=ids,
                     process_id=args.rank, num_processes=args.nranks,
                     mesh_devices=devices if len(devices) > 1 else None)
    finally:
        if started:
            dist.shutdown()
    if args.rank == 0:
        shutil.copy(out / "timings.json", point / "timings.json")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_point(args, point, nranks, mesh):
    """Start the processes of one sweep point and wait for them; all are
    stopped if one fails or the point outlasts ``--timeout``."""
    passed = []
    for k in PASSED:
        v = getattr(args, k)
        if v is not None:
            passed += [f"--{k}", str(v)]
    cmd = [sys.executable, "-m", "hydra_pspec_torch.scripts.scaling_test",
           *passed, "--worker", str(point), "--nranks", str(nranks),
           "--port", str(_free_port()), "--mesh", str(mesh)]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env)
             for r in range(nranks)]
    deadline = time.monotonic() + args.timeout
    try:
        rcs = [p.wait(timeout=max(1.0, deadline - time.monotonic()))
               for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if rcs != [0] * nranks:
        raise RuntimeError(f"{point.name}: the processes exited with {rcs}")


def _sample_files(res):
    return sorted(p.relative_to(res) for p in Path(res).rglob("*.npy"))


def table(out):
    """Read every sweep point of ``out``, print the table, and return
    ``(rows, all files identical to ranks-1)``."""
    out = Path(out)
    points = []
    for d in out.iterdir():
        kind, _, k = d.name.partition("-")
        if (d / "timings.json").exists() and kind in ("ranks", "devices"):
            points.append((kind != "ranks", int(k), d))
    points.sort()
    if not points:
        raise SystemExit(f"no sweep point with a timings.json in {out}")
    ref = out / REF if (out / REF / "timings.json").exists() \
        else points[0][2]
    t_ref = json.loads((ref / "timings.json").read_text())["rank_0_timers"]
    files = _sample_files(ref / "res")
    rows, ok = [], bool(files)
    print(f"{'point':12s} {'procs':>5s} {'devs':>4s} {'process s':>10s} "
          f"{'total s':>9s} {'speed-up':>8s} {'eff':>6s} {'speed-up':>8s} "
          f"{'eff':>6s}  files == {ref.name}")
    print(f"{'':12s} {'':>5s} {'':>4s} {'':>10s} {'':>9s} "
          f"{'(process)':>15s} {'(total)':>15s}")
    for by_devices, k, d in points:
        t = json.loads((d / "timings.json").read_text())
        tr = t["rank_0_timers"]
        same = _sample_files(d / "res") == files and all(
            (d / "res" / f).read_bytes() == (ref / "res" / f).read_bytes()
            for f in files)
        ok = ok and same
        row = {"point": d.name, "processes": t["num_ranks"],
               "devices": k if by_devices else t["num_ranks"],
               "process_s": tr["process"], "total_s": tr["total"],
               "identical": same}
        for timer in ("process", "total"):
            row[f"speedup_{timer}"] = t_ref[timer] / tr[timer]
            row[f"efficiency_{timer}"] = row[f"speedup_{timer}"] / k
        rows.append(row)
        print(f"{d.name:12s} {row['processes']:5d} {row['devices']:4d} "
              f"{tr['process']:10.3f} {tr['total']:9.3f} "
              f"{row['speedup_process']:8.3f} "
              f"{row['efficiency_process']:6.3f} "
              f"{row['speedup_total']:8.3f} {row['efficiency_total']:6.3f}"
              f"  {same}")
    print(f"{len(files)} sample files a point; every point identical to "
          f"{ref.name}: {ok}")
    return rows, ok


def main(argv=None):
    """The sweep (or one worker, or the table); returns the exit code."""
    args = build_parser().parse_args(argv)
    if args.worker:
        worker(args)
        return 0
    if args.table:
        return 0 if table(args.table)[1] else 1
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for kind, counts in (("ranks", _ints(args.ranks)),
                         ("devices", _ints(args.device_sweep))):
        for k in counts:
            t0 = time.perf_counter()
            point = out / f"{kind}-{k}"
            run_point(args, point, k if kind == "ranks" else 1,
                      k if kind == "devices" else 1)
            print(f"{point.name}: done in {time.perf_counter() - t0:.1f} s "
                  f"(processes started included)", flush=True)
    return 0 if table(out)[1] else 1


if __name__ == "__main__":
    sys.exit(main())
