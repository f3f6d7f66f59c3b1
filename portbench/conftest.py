"""pytest settings of the benchmark's own tests (portbench/tests/)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere, run with "
        "`python3 -m pytest portbench/tests -m gpu` on the card")


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided in the test, never
    at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)
