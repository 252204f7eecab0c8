"""Processes and devices of a run (the port's counterpart of
``hydra_pspec_tpu/parallel/mesh.py``): one process per device, host-side
collectives only.

The sampler's parallel axes, baselines and chains, are independent: no
collective runs inside the sampling loop (``mesh.py:1-9`` of the JAX
package). A run over N processes splits its baselines by the reference's
block rule (``partition.local_indices``); each process samples its block
on its own device, keyed on the global chain ids, and the only traffic is
a gather of per-baseline values (R-hat, write seconds) and a barrier at
the end. So the process group runs over **gloo**, on the card too: NCCL
would speed up nothing in that traffic, and NCCL refuses two ranks on one
GPU, which a one-card machine needs to run more than one process.

Inside one process, ``runner.run_baselines(mesh_devices=...)`` splits the
(baseline x chain) rows into contiguous blocks (:func:`shard_rows`), one
per device; the CLI in one process hands it every local card
(:func:`local_devices`). The JAX package pads the batch to a multiple of the device
count (``mesh.pad_batch``, ``partition.padded_baseline_slots``), because
SPMD needs equal global shards; the port has no global array, so it pads
nothing: a block is as long as the rule makes it.
"""
import os

import numpy as np
import torch
import torch.distributed as tdist

from .partition import local_indices


def initialize_distributed(coordinator, num_processes, process_id):
    """Join the run's process group over gloo at ``coordinator``
    (``host:port`` of process 0, the JAX CLI's ``--coordinator``). A no-op
    for one process. Returns whether a group was started."""
    if num_processes is None or num_processes <= 1:
        return False
    if not coordinator:
        raise ValueError("--num_processes > 1 needs --coordinator host:port "
                         "(process 0's address)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside "
                         f"[0, {num_processes})")
    tdist.init_process_group(backend="gloo",
                             init_method=f"tcp://{coordinator}",
                             world_size=num_processes, rank=process_id)
    return True


def shutdown():
    """Leave the process group, if one was started."""
    if tdist.is_available() and tdist.is_initialized():
        tdist.destroy_process_group()


def rank_device(device, process_id: int) -> torch.device:
    """This process's device, made current before any allocation:
    ``cuda:{LOCAL_RANK}`` when a launcher sets ``LOCAL_RANK``, else
    ``cuda:{process_id % device_count}``; an explicit index in ``device``
    is kept; a CPU device stays as it is."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if device.index is None:
        local = os.environ.get("LOCAL_RANK")
        index = (int(local) if local is not None
                 else process_id % torch.cuda.device_count())
        device = torch.device("cuda", index)
    torch.cuda.set_device(device)
    return device


def local_devices(device, process_id: int, num_processes: int):
    """This process's devices, the first made current: in a run of one
    process on ``"cuda"`` without an index, every local card (the JAX
    CLI's ``jax.devices()``, ``hydra_pspec_tpu/runner.py:341-344``), over
    which the runner splits its rows; otherwise the one device of
    :func:`rank_device` (an explicit index, the CPU, or one card a
    process)."""
    device = torch.device(device)
    count = torch.cuda.device_count() if device.type == "cuda" else 0
    if num_processes <= 1 and device.index is None and count > 1:
        devices = [torch.device("cuda", i) for i in range(count)]
        torch.cuda.set_device(devices[0])
        return devices
    return [rank_device(device, process_id)]


def barrier():
    """Wait for every process of the group (a no-op without one)."""
    if tdist.is_available() and tdist.is_initialized():
        tdist.barrier()


def gather_per_baseline(local, jobs, num_processes):
    """Per-baseline values (a scalar or a fixed-width 1D array each) of
    every process, on process 0: one ``[(bl_str, value), ...]`` list per
    rank in rank order, each value a float64 1D array, what the JAX
    package's ``cli/run.py::_gather_per_baseline`` returns (the
    reference's ``comm.gather(write_timings)``, run-hydra-pspec.py:557).
    Over the group with ``gather_object`` to process 0, which alone writes
    them, and which needs none of the JAX version's padding to
    ``ceil(n_baselines / P)`` rows and sentinels; the other processes get
    None. With one process, its own list."""
    order = [f"{j.antpair[0]}_{j.antpair[1]}" for j in jobs]
    mine = [(bl, np.atleast_1d(np.asarray(local[bl], dtype=np.float64)))
            for bl in order]
    if num_processes <= 1:
        return [mine]
    out = [None] * num_processes if tdist.get_rank() == 0 else None
    tdist.gather_object(mine, out, dst=0)
    return out


def shard_rows(n_rows: int, n_devices: int):
    """Contiguous row blocks, one per device, by the reference's block rule
    (the first ``n_rows % n_devices`` blocks one row longer); a device
    beyond the row count gets an empty block. No padding."""
    return [local_indices(n_rows, d, n_devices) for d in range(n_devices)]
