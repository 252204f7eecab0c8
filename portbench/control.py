"""The readings that the limits of ``limits/<cell>.json`` are set from,
on the card at the cell's own size, in one process:

    python3 portbench/control.py --workload <name> --seeds 12 \
        --control-seeds 3 [--chunks 3] [--first-seed S]

For each seed: the cell's data, one call of the entry point on every row
for ``--chunks`` chunks (as the timed call runs them), the check's sample
of its (chain, iteration) samples, and the widest gaps against the float64
reference (the program's readings, the lower ones). For the first
``--control-seeds`` seeds also the control: the reference computed in
float32 with TF32 products, put in the program's place at the same
states (the upper readings). Each reading is put through the run's own
decision (``check.verdict`` against ``limits/<cell>.json``), and its
verdict printed beside it. One JSON line a seed, then the summary.
The benchmark's own runs do not run this.
"""
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import numpy as np  # noqa: E402

import check  # noqa: E402
import harness  # noqa: E402


def readings(inp, samples, seed, precision):
    sids = list(range(inp.rows))
    rows_bl = [inp.baselines[r // inp.nchains] for r in range(inp.rows)]
    return check.run(samples, rows_bl, sids, seed, inp.prior, inp.ps0,
                     precision)


def control_samples(inp, samples, seed):
    """The control in the program's place: at each sampled state, the
    reference's iteration in float32 with TF32 products."""
    from reference import sampler
    bounded = sampler.bounded_bins(inp.prior)[0]
    table = sampler.invgamma_table(float(inp.nt))
    out = {}
    for (row, it), got in samples.items():
        bl = inp.baselines[row // inp.nchains]
        prev = inp.ps0 if got["prev"] is None else got["prev"]
        rnd = sampler.randomness(bl, seed, row, it, len(bounded))
        c = sampler.step(bl, prev, rnd, inp.prior, table, "tf32")
        out[(row, it)] = dict(prev=got["prev"], ps=c["ps"],
                              chisq=c["chisq"], ln_post=c["ln_post"])
    return out


def main(argv):
    import argparse
    import torch
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--chunks", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=2 ** 31 + 1001)
    args = p.parse_args(argv)
    spec, cell, config, traffic, limits = harness.load_cell(args.workload)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.say(f"needs {chips} CUDA device(s)")
        return 2
    from hydra_pspec_torch import runner
    devices = [torch.device(f"cuda:{i}") for i in range(chips)]
    low, up = {}, {}
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        inp = harness.Inputs(config, traffic, chips, seed, runner.BaselineJob)
        opts = dict(config["sampler"], device=devices[0], seed=seed,
                    nchains=inp.nchains, checkpoint=False,
                    mesh_devices=devices if chips > 1 else None)
        k = opts["write_niter"]
        niter = args.chunks * k
        t0 = time.perf_counter()
        res, _ = runner.run_baselines(inp.jobs, inp.prior, niter, **opts)
        t_prog = time.perf_counter() - t0
        pairs = check.pick(seed, inp.rows, niter, k)
        samples = {(r, it): {
            "prev": None if it == 0 else np.array(res[r].signal_ps[it - 1]),
            "ps": np.array(res[r].signal_ps[it]),
            "chisq": float(res[r].chisq[it]),
            "ln_post": float(res[r].ln_post[it])} for r, it in pairs}
        del res
        t0 = time.perf_counter()
        got = readings(inp, samples, seed, "fp64")
        line = {"seed": seed, "program": got,
                "program_correct": check.verdict(got, limits)[0],
                "program_s": t_prog, "check_s": time.perf_counter() - t0,
                "pairs": len(pairs)}
        for name, v in got.items():
            low[name] = max(low.get(name, 0.0), v)
        if i < args.control_seeds:
            ctl = readings(inp, control_samples(inp, samples, seed), seed,
                           "fp64")
            line["control"] = ctl
            line["control_correct"] = check.verdict(ctl, limits)[0]
            for name, v in ctl.items():
                up[name] = min(up.get(name, float("inf")), v)
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": args.workload,
                      "card": torch.cuda.get_device_name(0),
                      "lower": low, "upper": up, "limits": limits}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
