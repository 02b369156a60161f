"""An autouse fixture for the port's test files: one torch thread a test.

The tests run in several processes at once (pytest-xdist), each of which
would otherwise start a torch thread pool as wide as the machine; at the
sizes these tests use, the pools wait on each other far longer than they
compute. A test file takes it with ``from torch_threads import
one_torch_thread  # noqa: F401``.
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
