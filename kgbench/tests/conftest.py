"""CPU tests of the benchmark (``python -m pytest kgbench/tests``).

Tests that need a CUDA card take the ``card`` fixture and carry the
``card`` marker; the fixture skips them where there is none, deciding when
the test runs, never while a module is imported."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
