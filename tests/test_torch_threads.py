"""The port's CPU tests run on one torch intra-op thread: the tier runs test
files in parallel workers, and torch's default of a thread per core
oversubscribes the machine.  Each ``test_torch_*.py`` imports
:func:`one_torch_thread`, and pytest applies it to every test of that
module."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module's tests, the old count after."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_a_module_runs_on_one_torch_thread():
    assert torch.get_num_threads() == 1
