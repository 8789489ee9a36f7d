"""Tests of the benchmark itself. Those marked ``gpu`` need a CUDA card and
skip without one (the ``cuda`` fixture decides, at run time); run them on the
card with ``python3 -m pytest benchmark/tests -m gpu``. Nothing here imports
JAX."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda"
