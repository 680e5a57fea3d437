"""One pytest-xdist worker's share of the host's cores for the port's tests.

PyTorch runs its CPU ops on an OpenMP pool as wide as the host. Under
``pytest -n N`` each of the N workers starts such a pool, and N pools of
spinning threads on one host's cores slow every port test several fold:
six workers on eight cores ran ``test_train_step_matches_jitted_jax_step
[mixtral-8x7b-nothing]`` in 182 s each, and in 24 s each with a
one-thread pool (the same as one copy alone). Every ``tests/test_torch_*``
file calls ``share_cores()`` at import, so a worker's pool is narrowed
before its first test; outside xdist the pool is left as it is. The
numbers a test compares do not depend on it: a test that wants bit
equality compares two runs of one process.
"""
import os

import torch


def share_cores() -> None:
    """Narrow this process's intra-op pool to the cores it may use over the
    xdist worker count (at least 1)."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if workers > 1:
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0))
                                  // workers))
