"""Pytest settings of the harness's own tests (``pytest h100bench/tests``).

Tests that need the card carry the ``chip`` marker and take the ``card``
fixture, which decides inside the test run whether a CUDA card is there
and skips on the CPU."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skips on the CPU)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the H100")
    return torch.device("cuda", 0)
