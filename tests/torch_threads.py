"""A module-scoped, autouse fixture that runs torch on one thread for the
test file that imports it: beside five other test workers, a thread pool
per worker oversubscribes the cores and slows every worker down."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
