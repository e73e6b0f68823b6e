"""An autouse fixture for the port's CPU tests: two PyTorch CPU threads.

Import it into a test module (`from torch_threads import
few_torch_threads  # noqa: F401`). Under pytest-xdist every worker's
default PyTorch pool (one OpenMP thread a core) shares the machine's
cores with the other workers', and its threads then wait on one another:
a PyTorch-only CPU test measured 81 s against 9 s with two threads, beside
six busy processes on eight cores. The pool is restored after the module.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)
