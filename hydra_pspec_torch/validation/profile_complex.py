"""Time the complex float64 engine's step on the card.

    python -m hydra_pspec_torch.validation.profile_complex [--chains 16]

On the synthetic problem (``validation/synth.py``), ``--chains`` chains of
one baseline, lean: the step eagerly and as replays of a chunk graph of 20,
100 and 500 iterations (warm-up, capture and instantiation seconds, ms an
iteration), then ``torch.profiler``'s table of three eager steps by device
time. Prints the card's name and power limit first.
"""
import argparse
import subprocess
import time

import numpy as np
import torch

from ..models import gcr, gibbs
from ..ops.kernels.graph import ChunkGraph
from . import synth


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--chains", type=int, default=16)
    args = p.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    prob = synth.synthetic_problem()
    ops = gcr.build_chain_operators(prob.d, prob.w, prob.fgmodes, prob.ninv,
                                    device=dev)
    sids = torch.arange(args.chains, dtype=torch.int32, device=dev)
    ps0 = torch.as_tensor(np.tile(prob.ps_truth, (args.chains, 1)),
                          device=dev)
    prior, idx = gibbs.prior_on_device(prob.prior, dev)
    body = lambda: gibbs.chunk_body(ops, prior, idx, seed=1, sids=sids,
                                    store_cr=False, block=gibbs.CHAIN_BLOCK)
    run = body()
    run(ps0, 0, 2)
    torch.cuda.synchronize()
    t = time.perf_counter()
    run(ps0, 0, 20)
    torch.cuda.synchronize()
    print(f"eager: {(time.perf_counter() - t) / 20 * 1e3:.3f} ms an "
          f"iteration", flush=True)
    for k in (20, 100, 500):
        g = ChunkGraph(body(), ps0, k)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(3):
            g.replay(ps0, 1000 * i)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) / (3 * k) * 1e3
        print(f"graph K={k}: warm-up {g.warmup_s:.2f} s, capture "
              f"{g.capture_s:.2f} s, instantiate {g.instantiate_s:.2f} s; "
              f"replay {ms:.3f} ms an iteration", flush=True)
        del g
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(ps0, 0, 3)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=30,
                                    max_name_column_width=60), flush=True)


if __name__ == "__main__":
    main()
