import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


@pytest.fixture
def card():
    """Skips a card-only test where no CUDA device is present (decided
    here, never at import: every worker collects the same tests)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return "cuda"
