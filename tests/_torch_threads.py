"""The port's test files' shared thread policy: import `one_thread` into a
test module to run each of its tests on one intra-op thread."""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tiny models' small ops stall on a thread
    pool whose cores the other test workers hold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
