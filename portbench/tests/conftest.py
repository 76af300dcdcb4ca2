"""The benchmark's own tests: `python -m pytest portbench/tests -q`.

They run on the CPU at small sizes.  The ones marked `gpu` need a CUDA
device and skip without one (the fixture decides, at run time); on the
card machine they run a cell end to end."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; this machine has none")
    return torch.device("cuda", 0)
