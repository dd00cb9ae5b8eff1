"""The benchmark's own tests (``python -m pytest port_bench/tests``), on the
CPU at a small size; tests marked ``card`` run only where a CUDA card is."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the benchmark's runs are on the card)")
    return torch.device("cuda")
