"""PyTorch's CPU thread pool under ``pytest-xdist``: each worker its share
of the cores.

By default every worker starts one OpenMP thread per core, so ``-n 6`` on
eight cores runs ~48 spinning threads and the port's CPU tests take two
to five times as long as with one thread a worker. Each port test module
calls ``share_cores_between_workers()`` at import; the thread count is
process-wide and results do not depend on it. Outside xdist nothing
changes.
"""

import os

import torch


def share_cores_between_workers() -> None:
    """Give this xdist worker's intra-op pool cores // workers threads."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        cores = len(os.sched_getaffinity(0))
        torch.set_num_threads(max(1, cores // int(workers)))
