"""Shared set-up of the benchmark's own tests.

    python -m pytest sortbench/tests -q            # the CPU tests
    python -m pytest sortbench/tests -q -m cuda    # on a machine with the card

Tests marked ``cuda`` need the card; they decide inside the ``cuda`` fixture
and skip without one.
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
