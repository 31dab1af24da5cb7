"""The benchmark's own tests: ``python -m pytest perfbench/tests`` from
the repository's root.  Tests marked ``gpu`` need the card and skip
without one; the rest run on the CPU at tiny sizes."""

import sys
from pathlib import Path

import pytest
import torch

#: the tiny runs are many small operations: more threads only contend
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """Skip unless a CUDA card is there (decided when the test runs)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda")
