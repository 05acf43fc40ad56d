"""pytest settings of the benchmark's own tests (``python -m pytest
benchmark/tests``): the ``card`` marker of the tests that need a CUDA card,
and the fixture that decides, when a test runs, whether there is one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")
