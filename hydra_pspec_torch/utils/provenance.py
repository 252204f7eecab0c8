"""Run provenance and timing artifacts (port of
``hydra_pspec_tpu/utils/provenance.py``, same schemas).

The reference's output schema, so downstream tooling
(scripts/scaling_tests/plot_speed_up.py) reads the port's runs unchanged:
``timings.json`` (run-hydra-pspec.py:570-581), ``resources.json``
(:583-589), ``git.json`` (:350-356), ``args.json`` (:359-362), and the
``rhat.json`` convergence record."""
import json
import os
import subprocess
from pathlib import Path
from resource import RUSAGE_SELF, getrusage

import numpy as np


def get_git_version_info(directory=None):
    """Git origin/hash/describe/branch (reference utils.py:202-240); empty
    strings where git or the repository is absent."""
    if directory is None:
        directory = Path(__file__).resolve().parent
    info = {}
    cmds = {
        "git_origin": ["git", "config", "--get", "remote.origin.url"],
        "git_hash": ["git", "rev-parse", "HEAD"],
        "git_description": ["git", "describe", "--dirty", "--tag",
                            "--always"],
        "git_branch": ["git", "rev-parse", "--abbrev-ref", "HEAD"],
    }
    for key, cmd in cmds.items():
        try:
            info[key] = subprocess.check_output(
                cmd, cwd=directory, stderr=subprocess.STDOUT).decode().strip()
        except Exception:
            info[key] = ""
    return info


def write_git_json(out_dir, directory=None):
    with open(Path(out_dir) / "git.json", "w") as f:
        json.dump(get_git_version_info(directory), f, indent=2)


def write_args_json(out_dir, args_dict):
    with open(Path(out_dir) / "args.json", "w") as f:
        json.dump(args_dict, f, indent=2, default=str)


def write_timings_json(out_dir, *, num_ranks, num_baselines, load_data,
                       scatter, process, barrier, total, write_data):
    """The reference's schema (run-hydra-pspec.py:570-581): rank_0_timers
    plus the per-rank write timings."""
    timings = {
        "num_ranks": num_ranks,
        "num_baselines": num_baselines,
        "rank_0_timers": {
            "load_data": load_data,
            "scatter": scatter,
            "process": process,
            "barrier": barrier,
            "total": total,
        },
        "write_data": write_data,
    }
    with open(Path(out_dir) / "timings.json", "w") as f:
        json.dump(timings, f, indent=2)
    return timings


def write_rhat_json(out_dir, per_rank_entries):
    """The split-R-hat convergence diagnostic (the reference has none,
    SURVEY.md §5.5) as ``rhat.json``: max, median and per-bin values per
    baseline. ``per_rank_entries``: one list per rank of
    ``[(bl_str, per_bin_array), ...]``."""
    out = {}
    for entries in per_rank_entries:
        for bl, per_bin in entries:
            arr = np.asarray(per_bin, dtype=float)
            out[bl] = {
                "max": float(np.nanmax(arr)),
                "median": float(np.nanmedian(arr)),
                "per_bin": [round(float(v), 6) for v in arr],
            }
    with open(Path(out_dir) / "rhat.json", "w") as f:
        json.dump(out, f, indent=2)
    return out


def write_resources_json(out_dir):
    r = getrusage(RUSAGE_SELF)
    stats = {"ru_maxrss": r.ru_maxrss, "ru_utime": r.ru_utime,
             "ru_stime": r.ru_stime}
    with open(Path(out_dir) / "resources.json", "w") as f:
        json.dump(stats, f, indent=2)
    return stats


def touch_slurm_job_file(out_dir):
    """Empty SLURM job-id marker (reference run-hydra-pspec.py:363-365)."""
    if "SLURM_JOB_ID" in os.environ:
        (Path(out_dir) / os.environ["SLURM_JOB_ID"]).touch()
