"""The benchmark's own tests: the repository root on the import path, so
that ``portbench``, the port and ``chip_smoke`` import; the CPU only
unless a test is marked ``cuda`` (it then skips without a card)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided here, in
    the test, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
