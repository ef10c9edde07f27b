"""The benchmark's own tests: ``python -m pytest perfbench/tests``.

Tests that need a CUDA card carry the ``card`` marker and take the
``card`` fixture, which decides at run time (never at import) and skips
on a machine without one."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    return torch.device("cuda", 0)
