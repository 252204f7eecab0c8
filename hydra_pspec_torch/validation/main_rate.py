"""The main path's sampling rate on the card, as ``chip_smoke.py``'s main
phase measures it: ``runner.run_baselines`` on 100 baselines x 200
iterations at 203 times x 120 channels (megachain, files, checkpoint and
the runner's trace), and its iteration as a graph replay (a 5-iteration
chunk at B = 100 from the truth's bandpowers, CUDA events over 20
replays, three times), for one checkout or several in turn.

    python3 -m hydra_pspec_torch.validation.main_rate ROOT [ROOT ...] \
        [--out FILE]

Each ROOT is a checkout holding ``chip_smoke.py``. Each runs in a process
of its own, with the kernels built from its own sources, in the order
given, so ``OLD NEW NEW OLD`` compares two trees on one card. Prints the
card's name and power limit, then one line per run (sampling-only
baseline-iterations/s, process, write and staging seconds, the replayed
iteration's ms), and writes the runs as a JSON list to FILE.
"""
import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ITER_K, ITER_REPS = 5, 20


def graph_iteration_ms(chip_smoke, dev):
    """Three readings of the main path's iteration as a ``ChunkGraph``
    replay, from ``chip_smoke``'s own jobs and helpers (its
    ``phase_times`` case): ms an iteration."""
    import numpy as np
    import torch

    from hydra_pspec_torch.models import mega, megachain
    from hydra_pspec_torch.ops.kernels.graph import ChunkGraph

    mops, dims = chip_smoke.build_ops(
        chip_smoke.make_jobs(chip_smoke.N_BASELINES), dev)
    B = mops.nid.shape[0]
    ps = mega.pad_ps(np.tile(chip_smoke.ps_truth(), (B, 1)), dims, dev)
    body = megachain.chunk_body(
        mops, megachain.make_chain_tables(mops, dev), dims,
        megachain.prior_static_from(chip_smoke.make_prior(), dims),
        seed=chip_smoke.SEED,
        sids=torch.arange(B, dtype=torch.int32, device=dev), warm_ns=3,
        drift_max=0.6)
    cg = ChunkGraph(body, ps, ITER_K)
    return [chip_smoke._time(lambda: cg.replay(ps, 0), ITER_REPS) / ITER_K
            for _ in range(3)]


def child(root: Path, out: Path):
    """Build ``root``'s kernels and run its chip_smoke main phase once."""
    sys.path[0] = str(root)
    import torch

    import chip_smoke
    import hydra_pspec_torch
    from hydra_pspec_torch.ops.kernels import _build

    for mod in (chip_smoke, hydra_pspec_torch):
        if not Path(mod.__file__).resolve().is_relative_to(root):
            raise RuntimeError(f"{mod.__name__} imported from {mod.__file__}"
                               f", not from {root}")
    _build.build(verbose=False)
    _build.library()
    dev = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="main_rate_") as tmp:
        _, _, _, rate, host = chip_smoke.phase_main(dev, Path(tmp))
    host.pop("trace", None)
    out.write_text(json.dumps(dict(host, root=str(root), rate=rate,
                                   iteration_ms=graph_iteration_ms(
                                       chip_smoke, dev))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("roots", nargs="+")
    p.add_argument("--out", default=None)
    p.add_argument("--child", nargs=2, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        return child(Path(args.child[0]).resolve(), Path(args.child[1]))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    runs = []
    with tempfile.TemporaryDirectory(prefix="main_rate_") as tmp:
        for i, root in enumerate(args.roots):
            res = Path(tmp) / f"{i}.json"
            subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "x", "--child", str(Path(root).resolve()),
                            str(res)], check=True, cwd=root)
            r = json.loads(res.read_text())
            runs.append(r)
            print(f"[main_rate] {root}: sampling only {r['rate']} "
                  f"baseline-iterations/s; process {r['process']} s, write "
                  f"{r['write']} s, staging {r['staging']} s, fetch wait "
                  f"{r['fetch_wait']} s; replayed iteration "
                  f"{r['iteration_ms']} ms", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(runs, indent=1))
    return runs


if __name__ == "__main__":
    main()
