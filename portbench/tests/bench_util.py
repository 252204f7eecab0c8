"""Shared helpers of the benchmark's CPU tests: a cell cut to a size a test
run holds, and one run of it through ``harness.run_cell`` on CPU devices
(the harness's look for a card skipped)."""
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import harness  # noqa: E402

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]

TINY = dict(ntimes=20, nfreqs=16, nfgmodes=3, baselines_per_card=2)
TINY_FLAGS = [{"times": [3, 9], "channels": [2, 4]},
              {"times": [12, 20], "channels": [7, 8]}]


def tiny_cell(workload: str, chips: int = 0):
    """``harness.load_cell(workload)`` cut to 2 baselines a card x 2
    chains, 20 times x 16 channels, 3 modes, chunks of 10; on ``chips``
    devices where given, else on the cell's own."""
    spec, cell, config, traffic, limits = harness.load_cell(workload)
    cell = dict(cell, chips=chips or cell["chips"])
    config = dict(config, **TINY,
                  sampler=dict(config["sampler"], write_niter=10))
    traffic = dict(traffic, nchains=2)
    if traffic.get("flag_windows"):
        traffic["flag_windows"] = TINY_FLAGS
    return spec, cell, config, traffic, limits


def run_tiny(workload: str, seed: int = 4294967311, trace: int = 0,
             chips: int = 0):
    """One run of the tiny cell on CPU devices: the result dict."""
    import torch
    cell = tiny_cell(workload, chips)
    args = harness.parse(["--workload", workload, "--seed", str(seed),
                          "--seconds", "0.5", "--trace", str(trace)])
    devices = [torch.device("cpu")] * int(cell[1]["chips"])
    return harness.run_cell(args, cell, devices, time.perf_counter())
