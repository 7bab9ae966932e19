"""``one_torch_thread``: an autouse module fixture that runs torch on one
thread in the test files that import it.  The suite runs several test
processes on the machine's cores (pytest-xdist), and a torch pool of all
cores in each of them oversubscribes the host many times over: a port
predict that takes 3 s alone took 90 s so."""

from __future__ import annotations

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
