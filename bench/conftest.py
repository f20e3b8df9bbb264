"""The benchmark's tests. Tests marked ``card`` need an NVIDIA card and
skip without one; whether a card is there is decided in the ``card``
fixture when a test runs, never when a module is imported. Run them on
the card with ``PYTHONPATH=src python -m pytest -m card bench``."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (runs on the card only)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip(reason="needs a CUDA device: runs on the card only")
    return torch.device("cuda", 0)
