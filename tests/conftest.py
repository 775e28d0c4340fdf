"""Pytest settings: registers the marker for tests that need a CUDA card."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (CUDA kernels have no CPU "
        "mode); skips without one")
