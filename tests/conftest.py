"""Pytest settings: registers the marker for tests that need a CUDA card,
and runs the port's test modules (``test_torch_*.py``) with torch on one
CPU thread."""
import os

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (CUDA kernels have no CPU "
        "mode); skips without one")


@pytest.fixture(autouse=True, scope="module")
def _port_modules_on_one_thread(request):
    """Torch's CPU ops on one thread in each port test module.  The suite
    runs several pytest-xdist workers on the machine's cores; torch's
    intra-op pool on every core in each of them oversubscribes the CPU
    (a smoke model's backward ran about ten times slower than on one
    thread).  Other modules are left as they are."""
    if not os.path.basename(str(request.path)).startswith("test_torch_"):
        yield
        return
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
