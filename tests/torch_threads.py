"""One intra-op thread for torch in the port's heavier CPU tests.

The test suite runs in several worker processes at once, and torch's
default of one OpenMP thread per core in each of them oversubscribes the
machine (its threads spin while they wait), which made those files about
ten times slower than alone.  A test module opts in with

    from torch_threads import one_torch_thread  # noqa: F401

and the previous thread count is restored after the module.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
