"""Shared by the port's tests: the fixture that gives a test the CUDA card,
and the one that keeps a module's JAX reference on the CPU.

Tests that need the card carry ``@pytest.mark.cuda`` and take the ``cuda``
fixture, which skips them where there is none.  The decision is made when
the test runs, never at import, so every pytest worker collects the same
tests.  A module that holds the port to the JAX package on the card sets
``pytestmark = pytest.mark.usefixtures("jax_on_cpu")``.
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


@pytest.fixture(scope="module")
def jax_on_cpu():
    """Runs a module's JAX reference side on the host's CPU in full float32,
    whatever ``JAX_PLATFORMS`` says: JAX on a GPU computes float32 products
    at reduced precision, so the reference would drift from the port's
    float32 results by more than the parity tolerances."""
    import jax

    with jax.default_device(jax.devices("cpu")[0]), jax.default_matmul_precision("highest"):
        yield
