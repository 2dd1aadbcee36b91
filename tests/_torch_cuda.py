"""Shared by the port's tests: the fixture that gives a test the CUDA card.

Tests that need the card carry ``@pytest.mark.cuda`` and take the ``cuda``
fixture, which skips them where there is none.  The decision is made when
the test runs, never at import, so every pytest worker collects the same
tests.
"""

from __future__ import annotations

import pytest
import torch


@pytest.fixture
def cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")
