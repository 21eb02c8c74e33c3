"""Tests of the benchmark harness: `python -m pytest benchmark/tests -q`
from the repository root. Tests marked `card` need a CUDA device; they
skip here with a reason, decided inside the `card` fixture."""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
for p in (str(HERE), str(HERE.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (run on the chip)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
