"""Logical-axis → mesh-axis sharding rules (t5x-style), on DTensor.

The port of the JAX package's ``launch/sharding.py``.  Parameters declare
*logical* axes (``vocab``, ``embed``, ``mlp`` …); a rules table maps them
onto mesh axes.  The resolver drops any mapping whose dimension is not
divisible by the mesh-axis size (e.g. 8 KV heads on a 16-way model axis ⇒
replicate), so one rules table serves every arch.

Default placement = TP(model) on the wide feature dims + FSDP(pod, data)
on the other dim of every ≥2-D parameter; batch over (pod, data).

:class:`NamedSharding` stands in for JAX's: a mesh, a spec and the DTensor
placements, with ``shard_shape``; :func:`place` does what
``jax.device_put(tree, shardings)`` does, each rank keeping its shard.
Low-level resolution lives in ``launch/partition.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Placement

from repro_torch.launch.partition import (DEFAULT_RULES, Spec, cache_spec, constrain,
                                          current_mesh, mesh_sizes, place_local, placements,
                                          resolve_axes)
from repro_torch.models.params import ParamSpec

__all__ = ["DEFAULT_RULES", "resolve_axes", "constrain", "current_mesh", "NamedSharding",
           "sharding_for_spec", "param_shardings", "batch_shardings", "cache_sharding_rules",
           "place"]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``) with its DTensor placements."""

    mesh: DeviceMesh
    spec: Spec

    @property
    def placements(self) -> Tuple[Placement, ...]:
        return placements(self.spec, self.mesh)

    def shard_shape(self, global_shape) -> Tuple[int, ...]:
        """Each rank's local shape (the spec's mappings always divide)."""
        sizes = mesh_sizes(self.mesh)
        out = list(global_shape)
        for dim, entry in enumerate(self.spec):
            if entry is not None:
                for axis in entry if isinstance(entry, tuple) else (entry,):
                    out[dim] //= sizes[axis]
        return tuple(out)


def _tree_map(fn: Callable, tree, is_leaf: Callable) -> Any:
    """``fn`` on every leaf of a tree of dicts, lists and tuples."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, is_leaf) for v in tree)
    raise TypeError(f"not a tree: {type(tree).__name__}")


def _is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def sharding_for_spec(spec: ParamSpec, mesh: DeviceMesh,
                      rules: Optional[Dict] = None) -> NamedSharding:
    return NamedSharding(mesh, resolve_axes(spec.axes, spec.shape, mesh, rules))


def param_shardings(specs, mesh: DeviceMesh, rules: Optional[Dict] = None):
    """Spec tree -> NamedSharding tree."""
    return _tree_map(lambda s: sharding_for_spec(s, mesh, rules), specs, _is_spec)


def batch_shardings(mesh: DeviceMesh, abstract_batch, rules: Optional[Dict] = None):
    """Shard every batch leaf's leading (batch) dim over (pod, data)."""
    def sh(leaf):
        axes = ("batch",) + (None,) * (len(leaf.shape) - 1)
        return NamedSharding(mesh, resolve_axes(axes, leaf.shape, mesh, rules))
    return _tree_map(sh, abstract_batch, _is_tensor)


def cache_sharding_rules(mesh: DeviceMesh, abstract_caches, rules: Optional[Dict] = None):
    """Decode-state shardings (``partition.cache_spec`` for every leaf).

    Attention KV caches (B, T, KV, hd): batch over (pod,data); KV heads on
    ``model`` when divisible, else head_dim on ``model``, else replicate.
    Other 4-D and 3-D states split their dim 2 on ``model`` when divisible:
    N of Mamba-2's (B, H, N, P) state, P of a (B, H, P) state, the
    channels of a (B, conv, C) convolution state.  2-D states and scalars:
    batch only.  The models keep their decode states so placed
    (``models/lm.py``, ``models/encdec.py``).
    """
    return _tree_map(lambda leaf: NamedSharding(mesh, cache_spec(leaf.shape, mesh, rules)),
                     abstract_caches, _is_tensor)


def place(tree, shardings):
    """A tensor tree as DTensors, each leaf by its :class:`NamedSharding`
    (``jax.device_put(tree, shardings)``); the trees have the same form.
    Every rank passes the same whole values, as a host array is passed to
    ``device_put``, and keeps its own shard of each (no collective)."""
    if isinstance(tree, torch.Tensor):
        return place_local(tree, shardings.mesh, shardings.placements)
    if isinstance(tree, dict):
        return {k: place(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place(v, s) for v, s in zip(tree, shardings, strict=True))
    raise TypeError(f"not a tensor tree: {type(tree).__name__}")
