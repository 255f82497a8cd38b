"""A fixture that sizes torch's CPU thread pool to one xdist worker's share
of the cores.

Under `pytest -n N` every worker process would otherwise run torch's
intra-op pool at the full core count, and N pools contending for the same
cores slow the port's CPU tests by one to two orders of magnitude. Each
port test module imports the fixture; it applies to that module's tests
and restores the pool size after them. Without xdist it does nothing.
"""
import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def torch_threads_per_worker():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
    if workers <= 1:
        yield
        return
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)
