"""The harness's own tests: one torch thread; ``gpu`` marks what needs a
card, decided inside the ``card`` fixture."""

import pytest
import torch

torch.set_num_threads(1)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips itself without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)
