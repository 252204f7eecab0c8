"""One run of one cell of the port's benchmark (``run.py`` is the command).

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<config>.json``: the deployment's widths, noise, prior and
sampler settings) and a traffic mix (``traffic/<traffic>.json``: chains a
baseline, time flags); its window (``windows/<cell>.json``) fixes the
iterations of the timed call; every metric is read by
``metrics/<name>.py`` and the work of a roofline counted by
``work/<kernel>.py``. Nothing here names a cell, a configuration or a
metric.

A run: the seed's data; one warm call on the cell's rows, which loads
every kernel and makes the one-time allocations; the timed call of
``hydra_pspec_torch.runner.run_baselines`` for ``N`` iterations, a fixed
number of whole chunks that the window file gives for a number of
seconds, scaled to ``--seconds`` (so that every run of a cell does the
same work: an ``N`` read off the host's clock moves with the host, and
the rate with it); with ``--trace 1`` the same call traced (the
runner's own trace of one chunk's turn, or on the time-flags path a
profiler window around that turn); then the check of ``check.py`` on the
CPU, after the program's state is freed. The last line on standard
output is the result.
"""
import gc
import importlib.util
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np

import check
import synth
import chrometrace as trace_mod
from reference import sampler

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
TRACE_DIR = HERE / ".trace"
WARM_CHUNKS = 3                # the warm call, in chunks: both graph slots
MIN_CHUNKS = 3                 # the traced turn is the second chunk's
HOST_SHARE = 0.3               # of the host's free memory for one call
FORBIDDEN = ("jax", "jaxlib", "flax", "hydra_pspec_tpu")


def say(msg):
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def load_spec():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def load_cell(name: str):
    spec = load_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}: {sorted(cells)}")
    cell = cells[name]
    cfg = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((REPO / cfg["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    return spec, cell, config, traffic, limits


def load_window(name: str):
    """``windows/<cell>.json``: ``chunks`` of the timed call in a window
    of ``seconds``."""
    return json.loads((HERE / "windows" / f"{name}.json").read_text())


def metrics_for(spec, cell, trace: bool):
    """The cell's metric entries: end-to-end ones, or per-layer ones with
    ``--trace 1``."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell["name"] in m["workloads"]]


def reader(name: str):
    """``read(ctx)`` of ``metrics/<name>.py``: the metric's value, or None
    where the run holds nothing to read. ``ctx`` holds the timed calls and
    their ``timings``, the rows, the chips, ``setup_s``, the reduced trace
    (None without ``--trace 1``), the iterations of the traced turn, the
    cell's widths, and its configuration and traffic whole, so that a
    reader a later cell brings needs no change here."""
    path = HERE / "metrics" / f"{name}.py"
    mod = importlib.util.spec_from_file_location(f"metric_{name}", path)
    module = importlib.util.module_from_spec(mod)
    mod.loader.exec_module(module)
    return module.read


class Inputs:
    """The cell's rows from the seed: jobs for the program, and the same
    data as the reference reads it."""

    def __init__(self, config, traffic, chips, seed, BaselineJob):
        nt, nf, nm = (config["ntimes"], config["nfreqs"], config["nfgmodes"])
        if (config["noise"], config["S_initial"]) != ("diagonal", "identity"):
            raise SystemExit("the harness draws diagonal noise and starts "
                             "chains from S = I only")
        self.nbl = config["baselines_per_card"] * chips
        self.nchains = traffic["nchains"]
        self.rows = self.nbl * self.nchains
        self.prior = synth.prior(nf, config["prior_half_bins"],
                                 config["prior_factor"])
        flags = synth.time_flags(traffic.get("flag_windows"), nt, nf)
        rfi = traffic.get("rfi_amplitude", 0.0)
        data = synth.baselines(self.nbl, nt, nf, nm, seed % 2 ** 63,
                               config["ninv"])
        self.jobs = [BaselineJob(
            antpair=(b, b + 1),
            d=d if flags is None else d + rfi * flags,
            w=np.ones(nf), fgmodes=fg, S_initial=np.eye(nf), Ninv=ninv,
            out_dir=None, flags_tf=flags) for b, (d, fg, ninv) in
            enumerate(data)]
        groups = sampler.flag_groups(flags, nt, nf)
        self.group_times = [len(g.idx) for g in groups]
        self.baselines = [sampler.Baseline(j.d, j.fgmodes, j.Ninv, groups)
                          for j in self.jobs]
        self.ps0 = sampler.initial_bandpowers(np.eye(nf))
        self.n, self.m, self.nt = nf, nm, nt


class TflagsTrace:
    """A profiler window around one chunk's turn of the time-flags path,
    which takes no ``profile_dir``: the chunk runner of each flag signature
    is wrapped so that the window opens before the second chunk is
    dispatched and closes before the third (the second chunk's device
    work and its synchronous fetch), written as the runner writes its
    own."""

    def __init__(self, runner_mod, write_niter, out_dir, devices):
        self.mod, self.orig = runner_mod, runner_mod._tflags_megachain
        self.k, self.out, self.devices = write_niter, out_dir, devices
        self.prof = None

    def _mark(self, done):
        from torch.profiler import ProfilerActivity, profile
        if done == self.k and self.prof is None:
            _sync(self.devices)
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
        elif done == 2 * self.k and self.prof is not None:
            _sync(self.devices)
            self.prof.stop()
            self.out.mkdir(parents=True, exist_ok=True)
            self.prof.export_chrome_trace(str(self.out /
                                              "chunk-1.trace.json"))
            self.prof = False

    def __enter__(self):
        def wrapped(*args, **kw):
            run, to_state, chain_ps = self.orig(*args, **kw)

            def traced(ps, n, done):
                self._mark(done)
                return run(ps, n, done)
            return traced, to_state, chain_ps
        self.mod._tflags_megachain = wrapped
        return self

    def __exit__(self, *exc):
        self.mod._tflags_megachain = self.orig


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def host_bytes_free() -> int:
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    return 0


def parse(argv):
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start):
    """The command: exits 2 without the cards the cell asks for, else runs
    the cell on them and prints the result as the last line."""
    args = parse(argv)
    cell = load_cell(args.workload)
    chips = int(cell[1]["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        say(f"needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    out = run_cell(args, cell, [torch.device(f"cuda:{i}")
                                for i in range(chips)], t_start)
    if isinstance(out, int):
        return out
    print(json.dumps(out), flush=True)
    return 0


def _sync(devices):
    import torch
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def run_cell(args, cell, devices, t_start):
    """One run of ``cell`` (as :func:`load_cell` gives it) on ``devices``:
    the result dict, or an exit code where the run must print none."""
    import torch
    spec, cell, config, traffic, limits = cell
    window = load_window(cell["name"])
    chips = len(devices)
    from hydra_pspec_torch import runner
    from hydra_pspec_torch.ops.kernels import _build

    t_import = time.perf_counter()
    inp = Inputs(config, traffic, chips, args.seed, runner.BaselineJob)
    t_data = time.perf_counter()
    run_opts = dict(config["sampler"], device=devices[0], seed=args.seed,
                    nchains=inp.nchains, checkpoint=False,
                    mesh_devices=devices if chips > 1 else None)
    k = run_opts["write_niter"]
    flagged = traffic.get("flag_windows") is not None

    def call(niter, **extra):
        t0 = time.perf_counter()
        res, tim = runner.run_baselines(inp.jobs, inp.prior, niter,
                                        **run_opts, **extra)
        return res, tim, time.perf_counter() - t0

    # --- set-up: one warm call on every row, at the timed call's shapes --
    _, tw, ww = call(WARM_CHUNKS * k)
    chunks = max(MIN_CHUNKS, int(round(window["chunks"] * args.seconds
                                       / window["seconds"])))
    bytes_per_sample = 3 * (4 * inp.n + 8)
    per_call = max(MIN_CHUNKS, int(HOST_SHARE * host_bytes_free()
                                   / (bytes_per_sample * inp.rows * k)))
    plan = [min(per_call, chunks - i) for i in range(0, chunks, per_call)]
    say(f"{args.workload}: {inp.rows} rows on {chips} card(s); N = "
        f"{chunks * k} iterations in {len(plan)} call(s)")
    setup_s = time.perf_counter() - t_start
    say(f"set-up {setup_s:.3f} s: start to the program's import "
        f"{t_import - t_start:.3f} s, data {t_data - t_import:.3f} s, "
        f"warm call {ww:.3f} s (kernels loaded, host build "
        f"{tw['scatter']:.3f} s)")
    gc.collect()

    # --- the timed call(s) ---------------------------------------------
    _sync(devices)
    for d in devices:
        if d.type == "cuda":
            torch.cuda.reset_peak_memory_stats(d)
    _build.reset_launches()
    calls, first, failed = [], None, 0
    if args.trace:
        shutil.rmtree(TRACE_DIR, ignore_errors=True)
    for i, c in enumerate(plan):
        extra = {}
        hook = None
        if args.trace and i == 0:
            if flagged:
                hook = TflagsTrace(runner, k, TRACE_DIR, devices)
            else:
                extra["profile_dir"] = TRACE_DIR
        if hook:
            with hook:
                res, tim, wall = call(c * k, **extra)
        else:
            res, tim, wall = call(c * k, **extra)
        calls.append({"niter": c * k, "wall": wall, "timings": tim})
        failed += sum(int(np.count_nonzero(
            ~np.isfinite(r.signal_ps).all(axis=1) | ~np.isfinite(r.chisq)
            | ~np.isfinite(r.ln_post))) for r in res)
        if first is None:
            first = res
        del res
    say("timed call(s): " + "; ".join(
        f"{c['niter']} iterations in {c['wall']:.3f} s: " + ", ".join(
            f"{key} {c['timings'][key]:.3f}" for key in
            ("scatter", "process", "fetch_wait", "staging", "pin_alloc")
            if key in c["timings"]) for c in calls))
    launches = sum(v for kname, v in _build.LAUNCHES.items()
                   if kname not in ("hermitian_solve", "gcr_megastep"))
    cards = [d for d in devices if d.type == "cuda"]
    peak = max([torch.cuda.max_memory_allocated(d) for d in cards],
               default=0)
    kind = torch.cuda.get_device_name(cards[0]) if cards else "cpu"

    # --- the program's samples that the check reads; its state freed ----
    niter0 = plan[0] * k
    pairs = check.pick(args.seed, inp.rows, niter0, k)
    samples = {(r, it): {
        "prev": None if it == 0 else np.array(first[r].signal_ps[it - 1]),
        "ps": np.array(first[r].signal_ps[it]),
        "chisq": float(first[r].chisq[it]),
        "ln_post": float(first[r].ln_post[it])} for r, it in pairs}
    del first
    gc.collect()
    torch.cuda.empty_cache()
    bad = forbidden_modules()
    if bad:
        say(f"the process holds {bad} after the window: refused")
        return 3

    # --- metrics ---------------------------------------------------------
    tr = None
    device = {"platform": "gpu" if cards else "cpu", "kind": kind,
              "count": chips, "memory_peak_bytes": int(peak)}
    if args.trace:
        files = sorted(TRACE_DIR.glob("chunk-*.trace.json"))
        if len(files) != 1:
            say(f"no single trace of a chunk's turn: {files}")
            return 4
        tr = trace_mod.read(files[0])
        shutil.rmtree(TRACE_DIR, ignore_errors=True)
        want = launches / sum(plan)
        if len(tr.kernels) < want:
            say(f"the trace holds {len(tr.kernels)} kernel records, fewer "
                f"than the {want:.1f} launches of one chunk: records lost")
            return 5
        device["busy_s"] = float(np.mean(list(tr.busy_s.values()) or [0]))
        device["window_s"] = tr.window_s
    ctx = {"calls": calls, "rows": inp.rows, "chips": chips,
           "setup_s": setup_s, "trace": tr, "iters_in_turn": k,
           "config": config, "traffic": traffic,
           "widths": {"n": inp.n, "m": inp.m, "group_times": inp.group_times,
                      "alpha": inp.nt - 1, "chains": inp.rows // chips,
                      "baselines": inp.nbl // chips}}
    metrics = {}
    for m in metrics_for(spec, cell, bool(args.trace)):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # --- the check --------------------------------------------------------
    t0 = time.perf_counter()
    sids = list(range(inp.rows))       # global chain ids: b * nchains + c
    rows_bl = [inp.baselines[r // inp.nchains] for r in range(inp.rows)]
    worst = check.run(samples, rows_bl, sids, args.seed, inp.prior, inp.ps0)
    say(f"check: {len(samples)} samples against the reference in "
        f"{time.perf_counter() - t0:.2f} s")
    correct, compared = check.verdict(worst, limits, failed)
    out = {"correct": correct, "attempted": inp.rows * sum(plan) * k,
           "failed": failed, "metrics": metrics, "device": device}
    if tr is not None:
        out["breakdown"] = trace_mod.breakdown(tr)
    out["check"] = compared
    for k2, v in compared.items():
        say(f"{k2} {v['value']!r} limit {v['limit']!r}")
    return out
