"""The main path's sampling rate on the card, as ``chip_smoke.py``'s main
phase measures it: ``runner.run_baselines`` on 100 baselines x 200
iterations at 203 times x 120 channels (megachain, files, checkpoint and
the runner's trace), for one checkout or several in turn.

    python3 -m hydra_pspec_torch.validation.main_rate ROOT [ROOT ...] \
        [--out FILE]

Each ROOT is a checkout holding ``chip_smoke.py``. Each runs in a process
of its own, with the kernels built from its own sources, in the order
given, so ``OLD NEW NEW OLD`` compares two trees on one card. Prints the
card's name and power limit, then one line per run (sampling-only
baseline-iterations/s, process, write and staging seconds), and writes
the runs as a JSON list to FILE.
"""
import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path


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
    out.write_text(json.dumps(dict(host, root=str(root), rate=rate)))


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
                  f"{r['fetch_wait']} s", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(runs, indent=1))
    return runs


if __name__ == "__main__":
    main()
