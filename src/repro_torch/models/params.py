"""Parameter-spec system: shapes + logical axes first, tensors later.

The port of the JAX package's ``models/params.py``.  Models declare their
parameters as a nested dict (and, for the LM's layers, a list) of
:class:`ParamSpec` (shape, logical axes, dtype, initializer).  From the
spec tree come ``initialize(specs, generator, device)`` (real tensors
drawn from an explicit ``torch.Generator``, or empty ones on the ``meta``
device), ``abstract(specs)`` (``meta`` tensors of each spec's shape and
dtype, the JAX package's ``ShapeDtypeStruct``s), ``logical_axes(specs)``
(the axes tree that :mod:`repro_torch.launch.sharding` maps onto a mesh),
``param_count`` and ``tree_bytes``.

The initializers follow the JAX package's rules (``"normal"`` × scale,
``"scaled_normal"`` by fan-in = ``shape[-2]``, both sampled in float32 and
then cast).  ``jax.random`` streams cannot be reproduced in PyTorch, so the
same seed gives other numbers; ``repro_torch.convert.lm_params_from_jax``
carries the JAX package's parameters across where the numbers must agree.
Leaves are drawn in the JAX package's flattening order (dict keys sorted,
list items in order).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator, Optional, Tuple

import torch

__all__ = ["ParamSpec", "abstract", "initialize", "logical_axes", "cast_specs", "param_count",
           "tree_bytes"]

Initializer = str  # "normal" | "zeros" | "ones" | "scaled_normal"


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.bfloat16
    init: Initializer = "normal"
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} mismatch")


def _tree_map(fn: Callable[[ParamSpec], Any], tree) -> Any:
    """``fn`` on every spec of a tree of dicts and lists, keeping its form."""
    if isinstance(tree, ParamSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    raise TypeError(f"not a spec tree: {type(tree).__name__}")


def _leaves(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, ParamSpec]]:
    """(path, spec) pairs in the JAX package's order: keys sorted."""
    if isinstance(tree, ParamSpec):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        raise TypeError(f"not a spec tree: {type(tree).__name__}")


def abstract(specs) -> Any:
    """Spec tree -> ``meta`` tensors of the specs' shapes and dtypes (no
    allocation)."""
    return _tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), specs)


def logical_axes(specs) -> Any:
    """Spec tree -> the tree of each spec's logical axes."""
    return _tree_map(lambda s: s.axes, specs)


def _init_one(spec: ParamSpec, generator: torch.Generator,
              device: torch.device) -> torch.Tensor:
    if device.type == "meta":
        return torch.empty(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "normal":
        scale = spec.scale
    elif spec.init == "scaled_normal":
        # variance-scaled by fan-in (last-but-one dim if 2D+)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    else:
        raise ValueError(f"unknown init {spec.init!r}")
    out = torch.randn(spec.shape, generator=generator, dtype=torch.float32, device=device)
    return out.mul_(scale).to(spec.dtype)


def initialize(specs, generator: Optional[torch.Generator],
               device: torch.device | str) -> Any:
    """Spec tree -> real tensors on ``device``, drawn from ``generator``
    (on that device; ignored, and may be None, on ``meta``)."""
    device = torch.device(device)
    out = _tree_map(lambda s: s, specs)          # a copy of the tree to fill
    for path, spec in _leaves(specs):
        node = out
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = _init_one(spec, generator, device)
    return out


def cast_specs(specs, dtype: torch.dtype) -> Any:
    """Replace the default (bfloat16) param dtype throughout a spec tree.

    Norm/gate params declared explicitly float32 stay float32 (mixed
    precision); only the bf16 defaults are re-targeted.
    """
    def _cast(s: ParamSpec) -> ParamSpec:
        if s.dtype == torch.bfloat16:
            return dataclasses.replace(s, dtype=dtype)
        return s
    return _tree_map(_cast, specs)


def param_count(specs) -> int:
    return sum(math.prod(s.shape) for _, s in _leaves(specs))


def tree_bytes(specs) -> int:
    return sum(math.prod(s.shape) * s.dtype.itemsize for _, s in _leaves(specs))
