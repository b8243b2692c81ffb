"""The harness's CPU tests serve timed windows: one intra-op thread each, so
that test workers running side by side do not starve each other's windows."""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
