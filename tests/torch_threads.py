"""The port's CPU test files share the machine's cores between the pytest
workers.

A PyTorch process starts one intra-op thread per core. Under pytest-xdist
every worker is such a process, so six workers on eight cores keep ~48
threads busy, and each PyTorch op of a port test waits on the others' (a
run of the port's files with 4 workers on an 8-core CPU took 2,936 s of
worker time with the default threads and 812 s with 2 threads each; XLA's own threads are
not touched). Each port test module imports :func:`torch_threads`, which,
while the module runs, gives torch the worker's share of the cores.
"""

import os

import pytest
import torch


def threads_per_worker() -> int:
    """The cores this process may run on, divided among the xdist workers
    (one worker when xdist is off), at least 1."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, len(os.sched_getaffinity(0)) // workers)


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(threads_per_worker())
    yield
    torch.set_num_threads(before)
