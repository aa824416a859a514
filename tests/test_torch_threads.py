"""The CPU threads the port's tests give torch.

The suite runs in several pytest-xdist worker processes, and torch gives
each process one intra-op thread per core: n workers then run n × cores
threads, and a parallel region waits on peers that the OS has
descheduled. On 8 cores with 6 workers the K=3 fleet tests took 7–13×
their time alone. Each test_torch_ file that computes with torch calls
`share_cores()` when it is imported, so every worker takes its share of
the cores; a file run without xdist keeps them all.
"""
import os

import torch


def cores_per_worker() -> int:
    cores = len(os.sched_getaffinity(0)) if hasattr(
        os, "sched_getaffinity") else (os.cpu_count() or 1)
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, cores // workers)


def share_cores() -> None:
    torch.set_num_threads(cores_per_worker())


share_cores()


def test_torch_takes_this_workers_share_of_the_cores():
    assert torch.get_num_threads() == cores_per_worker()
