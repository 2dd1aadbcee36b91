"""The JAX package's lowering of ``jax.nn.silu`` and ``jax.nn.gelu``, for
diagnostics of the port's bfloat16 rounding (``ROADMAP.md`` §3, Open item
1): not used by the port.

``jax.nn.silu`` lowers to ``x * (1 / (1 + exp(-x)))`` with every op in the
operand's dtype, and ``jax.nn.gelu`` (the tanh approximation, its default)
to ``x * (0.5 * (1 + tanh(c * (x + k * x³))))`` the same way, its constants
cast to that dtype first; the port's ``F.silu`` and ``F.gelu`` compute in
float32 and round once.  :func:`install` makes the port's model modules
(``layers``, ``moe``, ``ssm``) call these in place of ``F.silu`` and
``F.gelu`` until the returned function undoes it.  It imports torch and the
port only, so the card's scripts can use it.
"""

from __future__ import annotations

import math
import types

import torch
import torch.nn.functional as F

MODULES = ("layers", "moe", "ssm")


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * (1 / (1 + torch.exp(-x)))


def gelu(x: torch.Tensor, approximate: str = "tanh") -> torch.Tensor:
    assert approximate == "tanh", approximate
    c, k = (float(torch.tensor(v, dtype=x.dtype)) for v in (math.sqrt(2 / math.pi), 0.044715))
    return x * (0.5 * (1 + torch.tanh(c * (x + k * (x * (x * x))))))


def install():
    """The port's model modules on the lowering; returns the undo."""
    import importlib

    shim = types.SimpleNamespace(**{n: getattr(F, n) for n in dir(F) if not n.startswith("__")})
    shim.silu, shim.gelu = silu, gelu
    mods = [importlib.import_module(f"repro_torch.models.{m}") for m in MODULES]
    for m in mods:
        m.F = shim

    def undo():
        for m in mods:
            m.F = F
    return undo
