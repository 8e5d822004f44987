"""Tests of the benchmark harness. The CPU tests run everywhere; a test
marked ``chip`` needs a CUDA card and skips without one, deciding inside
the test, never while the module is imported:

    python -m pytest -q -m chip portbench/tests
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (skips on a machine without one)")


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is there."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: runs on the chip")
    return torch.device("cuda")


@pytest.fixture
def root():
    return ROOT


@pytest.fixture
def one_thread():
    """One intra-op thread for a whole run of the harness on the CPU (the
    suite's other workers share the cores), restored after."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
