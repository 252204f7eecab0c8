"""The main path's sampling rate on the card, as ``chip_smoke.py``'s main
phase measures it: ``runner.run_baselines`` on 100 baselines x 200
iterations at 203 times x 120 channels (megachain, files, checkpoint and
the runner's trace), and its iteration as a graph replay (a 5-iteration
chunk at B = 100 from the truth's bandpowers, CUDA events over 20
replays, three times), for one checkout or several in turn.

    python3 -m hydra_pspec_torch.validation.main_rate ROOT [ROOT ...] \
        [--out FILE] [--iterations]

Each ROOT is a checkout holding ``chip_smoke.py``. Each runs in a process
of its own, with the kernels built from its own sources, in the order
given, so ``OLD NEW NEW OLD`` compares two trees on one card. Prints the
card's name and power limit, then one line per run (sampling-only
baseline-iterations/s, process, write and staging seconds, the replayed
iteration's ms, and the grouped time-flags path's replayed iteration: 100
chains x G = 3 rows of signature A, the same way), and writes the runs as
a JSON list to FILE. ``--iterations`` times the two replayed iterations
alone, without the main phase's run.
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


def grouped_iteration_ms(chip_smoke, dev):
    """Three readings of the grouped time-flags path's iteration (100
    chains of one job under signature A, G = 3 rows a chain) as a
    ``ChunkGraph`` replay, from ``chip_smoke``'s helpers (its
    ``phase_times`` grouped case): ms an iteration."""
    import numpy as np

    from hydra_pspec_torch.models import mega, megachain
    from hydra_pspec_torch.ops.kernels.graph import ChunkGraph

    nchains = chip_smoke.N_BASELINES
    gs = chip_smoke.grouped_setup(chip_smoke.make_jobs(1),
                                  chip_smoke.tflag_signatures()[0], nchains,
                                  dev)
    _, sids, sidc = chip_smoke.grouped_ids(gs, nchains, dev)
    B = gs.mops.nid.shape[0]
    ps = mega.pad_ps(np.tile(chip_smoke.ps_truth(), (B, 1)), gs.dims, dev)
    body = megachain.chunk_body(
        gs.mops, megachain.make_chain_tables(gs.mops, dev), gs.dims,
        megachain.prior_static_from(chip_smoke.make_prior(), gs.dims),
        seed=chip_smoke.SEED, sids=sids, sidc=sidc, warm_ns=3,
        drift_max=0.6, group_times=gs.group_times, group_idx=gs.group_idx)
    cg = ChunkGraph(body, ps, ITER_K)
    return [chip_smoke._time(lambda: cg.replay(ps, 0), ITER_REPS) / ITER_K
            for _ in range(3)]


def child(root: Path, out: Path, iterations_only: bool = False):
    """Build ``root``'s kernels and run its chip_smoke main phase once
    (unless ``iterations_only``), then time the replayed iterations."""
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
    host, rate = {}, None
    if not iterations_only:
        with tempfile.TemporaryDirectory(prefix="main_rate_") as tmp:
            _, _, _, rate, host = chip_smoke.phase_main(dev, Path(tmp))
        host.pop("trace", None)
    out.write_text(json.dumps(dict(
        host, root=str(root), rate=rate,
        iteration_ms=graph_iteration_ms(chip_smoke, dev),
        grouped_iteration_ms=grouped_iteration_ms(chip_smoke, dev))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("roots", nargs="+")
    p.add_argument("--out", default=None)
    p.add_argument("--iterations", action="store_true",
                   help="the replayed iterations alone, no main phase")
    p.add_argument("--child", nargs=2, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        return child(Path(args.child[0]).resolve(), Path(args.child[1]),
                     args.iterations)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    runs = []
    with tempfile.TemporaryDirectory(prefix="main_rate_") as tmp:
        for i, root in enumerate(args.roots):
            res = Path(tmp) / f"{i}.json"
            subprocess.run([sys.executable, str(Path(__file__).resolve()),
                            "x", "--child", str(Path(root).resolve()),
                            str(res)]
                           + (["--iterations"] if args.iterations else []),
                           check=True, cwd=root)
            r = json.loads(res.read_text())
            runs.append(r)
            rate = ("" if r["rate"] is None else
                    f"sampling only {r['rate']} baseline-iterations/s; "
                    f"process {r['process']} s, write {r['write']} s, "
                    f"staging {r['staging']} s, fetch wait "
                    f"{r['fetch_wait']} s; ")
            print(f"[main_rate] {root}: {rate}replayed iteration "
                  f"{r['iteration_ms']} ms, grouped "
                  f"{r['grouped_iteration_ms']} ms", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(runs, indent=1))
    return runs


if __name__ == "__main__":
    main()
