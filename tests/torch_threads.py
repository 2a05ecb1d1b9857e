"""A fixture for the port's tests of the pure mode: its connected
components run many short torch ops, and beside the other test workers a
full thread team per op oversubscribes the cores many times over, so those
tests run torch on two threads."""
import pytest
import torch


@pytest.fixture
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)
