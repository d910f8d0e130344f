"""The benchmark's own tests: CPU runs of the harness at a tiny size, and
the card's tests (marked ``gpu``), which skip without a card.

    python -m pytest -q benchmark/tests
"""

import os
import sys

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the control in TF32 only differs there)")
    torch.set_num_threads(min(4, torch.get_num_threads()))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
