"""Tests of the benchmark harness. Run from the repository root:

    python -m pytest slotbench/tests -q

They run on the CPU at small sizes. Tests marked ``card`` need a CUDA card
and skip without one (from the ``card`` fixture); on the card's machine run
``python -m pytest slotbench/tests -q -m card``.
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card")


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
