"""Baseline partitioning across processes (the port's own copy of
``hydra_pspec_tpu/parallel/partition.py``, which it may not import).

The reference's block rule (run-hydra-pspec.py:268-287): ``quot + 1``
items for the first ``rem`` ranks, so per-rank workloads compare directly
with the reference's scaling study."""
from typing import Sequence


def split_for_ranks(data: Sequence, n_ranks: int):
    """Contiguous block partition of a list into ``n_ranks`` sublists
    (reference ``split_data_for_scatter``). Raises when there are fewer
    items than ranks (the reference calls comm.Abort,
    run-hydra-pspec.py:273-277)."""
    n = len(data)
    quot, rem = divmod(n, n_ranks)
    if quot == 0:
        raise ValueError(
            f"Number of baselines ({n}) should be >= number of ranks "
            f"({n_ranks})")
    counts = [quot + 1 if r < rem else quot for r in range(n_ranks)]
    out, start = [], 0
    for c in counts:
        out.append(list(data[start:start + c]))
        start += c
    return out


def local_indices(n_items: int, process_id: int, num_processes: int):
    """Index range this process owns under :func:`split_for_ranks`: each
    process reads only its own baselines (the reference loads everything
    on rank 0, scaling_tests_README.md:74-80)."""
    quot, rem = divmod(n_items, num_processes)
    start = process_id * quot + min(process_id, rem)
    count = quot + (1 if process_id < rem else 0)
    return range(start, start + count)


def padded_baseline_slots(n_items: int, num_processes: int, n_devices: int,
                          nchains: int = 1) -> int:
    """Global padded baseline count of a multi-process batch: the smallest
    multiple of ``num_processes`` whose per-process slot count covers the
    largest :func:`local_indices` block and whose (baseline x chain) batch
    divides evenly over all devices. Slots beyond a process's real
    baselines hold dummy chains whose outputs are dropped."""
    if n_items < num_processes:
        raise ValueError(
            f"Number of baselines ({n_items}) should be >= number of "
            f"ranks ({num_processes})")
    m = num_processes * (-(-n_items // num_processes))
    while (m * nchains) % n_devices != 0:
        m += num_processes
    return m
