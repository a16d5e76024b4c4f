"""CPU tests of the benchmark's harness (`python -m pytest perfbench/tests`).

Tests that need a CUDA card carry the `card` marker and skip without one;
whether a card is present is decided inside the `card` fixture, never
while a module is imported."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card present")
    return torch.device("cuda:0")
