"""The port's activations against the JAX package's: ``layers.silu`` and
``layers.gelu_tanh`` equal ``jax.nn.silu`` and ``jax.nn.gelu`` bit for bit
on every finite bfloat16 value, the sign of zero included, and within the
float32 parity tolerance in float32.

``jax.nn.silu`` is ``x * logistic(x)`` and ``jax.nn.gelu`` the tanh
formula, and each op of both rounds in the operand's dtype; ``F.silu`` and
``F.gelu`` compute in float32 and round once, and a case shows that they
would fail the bfloat16 equality.

XLA's CPU flushes subnormals to zero, in its inputs and its results, and
PyTorch's CPU does not by default: the bfloat16 cases run with
``torch.set_flush_denormal(True)``, and on one thread, since the flag is
the calling thread's own (a large tensor's op split over the intra-op
threads would flush on one of them only).  The fixture then sets the
thread count back and the flush off again (PyTorch's default; it has no
getter).  Without the flush the lowering differs on about 500 of the
65,280 values, each with a subnormal input, output or intermediate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_cuda import jax_on_cpu  # noqa: F401  (fixture)
from repro_torch.models import layers as L

pytestmark = pytest.mark.usefixtures("jax_on_cpu")   # the JAX reference on the CPU

F32_TOL = dict(rtol=2e-4, atol=2e-4)     # tests/test_torch_kernels.py's float32 TOL

PAIRS = {"silu": (L.silu, jax.nn.silu, F.silu),
         "gelu": (L.gelu_tanh, jax.nn.gelu, lambda x: F.gelu(x, approximate="tanh"))}


@pytest.fixture
def flushed():
    """Subnormals flushed to zero, as XLA's CPU flushes them, on one
    thread; afterwards the thread count as it was and the flush off."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)
        torch.set_num_threads(threads)


def _every_finite_bfloat16():
    """Every finite bfloat16 value (65,280: both zeros, the subnormals,
    the normals), as a torch tensor and the same bits as a JAX array."""
    bits = np.arange(1 << 16, dtype=np.uint16)
    finite = (bits & 0x7F80) != 0x7F80
    bits = bits[finite]
    return (torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16),
            jnp.asarray(bits).view(jnp.bfloat16))


def _differ(got: torch.Tensor, want) -> int:
    """The count of values whose bits differ."""
    return int((got.view(torch.int16).numpy() != np.asarray(want).view(np.int16)).sum())


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_bfloat16_bit_for_bit_on_every_value(name, flushed):
    x, xj = _every_finite_bfloat16()
    assert x.numel() == 65280
    port, ref, _ = PAIRS[name]
    got = port(x)
    assert got.dtype == torch.bfloat16
    with jax.disable_jit():                  # eager: each op rounds as the program says
        want = ref(xj)
    assert _differ(got, want) == 0
    assert _differ(got, ref(xj)) == 0        # and compiled


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_rounding_once_fails_the_bfloat16_equality(name, flushed):
    """``F.silu`` and ``F.gelu`` round once (1,358 and 1,010 of the 65,280
    values differ here): the equality above tells them apart."""
    x, xj = _every_finite_bfloat16()
    _, ref, once = PAIRS[name]
    assert _differ(once(x), ref(xj)) > 1000


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_float32_within_the_parity_tolerance(name):
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(100_000) * 4,
                        np.linspace(-100, 100, 20_001)]).astype(np.float32)
    port, ref, once = PAIRS[name]
    got = port(torch.from_numpy(x))
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, torch.from_numpy(np.array(ref(jnp.asarray(x)))), **F32_TOL)
    assert torch.equal(got, once(torch.from_numpy(x)))      # one launch on a card
    assert port(torch.from_numpy(x).double()).dtype == torch.float64
