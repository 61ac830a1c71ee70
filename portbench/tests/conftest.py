"""The benchmark's own tests.  Tests that need a CUDA card carry the
`card` marker and skip elsewhere; whether a card is present is decided
inside the `card` fixture, never while a module is imported.  Run them on
the card with

    python -m pytest portbench/tests -m card
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    return torch.cuda.get_device_name(0)
