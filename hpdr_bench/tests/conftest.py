"""The benchmark's tests: run from the root with
``python -m pytest -q hpdr_bench/tests`` (the ``gpu`` ones on a card)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """The first CUDA card; the test skips where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)



@pytest.fixture
def tiny():
    """A size a CPU test holds: two 17^3 fields (MGARD pads them to 17^3, ZFP to 20^3)."""
    return {"shape": [17, 17, 17], "fields": ["a", "b"]}
