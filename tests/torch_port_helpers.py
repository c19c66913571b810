"""Shared fixture of the PyTorch-port tests (tests/test_torch_*.py)."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run each port test module on one torch thread: the suite runs
    several pytest workers side by side, and the port's small-tensor ops
    gain nothing from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
