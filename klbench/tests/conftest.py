"""The benchmark's own tests: ``python -m pytest klbench/tests`` from the
checkout's root (``-m gpu`` on a card for the card's cases)."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture()
def cuda():
    """Skip unless a CUDA device is present, decided at run time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
