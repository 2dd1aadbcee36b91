"""Low-level logical-axis partitioning helpers (no model imports).

The port of the JAX package's ``launch/partition.py``.  Split out of
``launch/sharding.py`` so that model code can call :func:`constrain`
without an import cycle (models → partition ← sharding → models.params).

A spec, the port's ``PartitionSpec``, is a tuple with one entry per
leading tensor dim: ``None`` (replicated), a mesh axis name, or a tuple of
names, major to minor; trailing ``None``s are trimmed, as JAX trims them.
:func:`placements` turns it into DTensor placements, one per mesh dim: a
dim on two mesh axes is ``Shard(d)`` on both, which DTensor splits in mesh
order, the JAX package's major-to-minor split when the names come in mesh
order (they always do from :data:`DEFAULT_RULES`).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh, _mesh_resources
from torch.distributed.tensor import DTensor, Partial, Placement, Replicate, Shard

__all__ = ["DEFAULT_RULES", "Spec", "resolve_axes", "mesh_sizes", "placements", "mentions",
           "current_mesh", "constrain", "split_heads", "gathered", "local", "on_replicated",
           "on_batch_shards"]

Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]

# logical axis -> mesh axis name(s); "__fsdp__"/"__batch__" expand to the
# present subset of ("pod", "data").
DEFAULT_RULES: Dict[str, object] = {
    "layers": None,
    "vocab": "model",
    "embed": "__fsdp__",
    "q_proj": "model",
    "kv_proj": "model",
    "heads": "model",
    "head_dim": None,
    "mlp": "model",
    "expert": "model",
    "conv": None,
    "state": None,
    "unsharded": None,
    # activation axes
    "batch": "__batch__",
    "seq": None,
    "kv_seq": None,
}


def mesh_sizes(mesh: Union[DeviceMesh, Mapping[str, int]]) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a mapping of the same."""
    if isinstance(mesh, DeviceMesh):
        if mesh.mesh_dim_names is None:
            raise ValueError("the mesh has no axis names")
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh)


def _expand(rule, sizes: Mapping[str, int]):
    if rule in ("__fsdp__", "__batch__"):
        axes = tuple(a for a in ("pod", "data") if a in sizes)
        return axes if axes else None
    return rule


def resolve_axes(axes: Sequence[Optional[str]], shape: Sequence[int],
                 mesh: Union[DeviceMesh, Mapping[str, int]],
                 rules: Optional[Dict] = None) -> Spec:
    """Logical axes tuple -> spec, dropping non-divisible mappings and never
    assigning one mesh axis twice.  Reads only the mesh's axis sizes."""
    sizes = mesh_sizes(mesh)
    rules = {**DEFAULT_RULES, **(rules or {})}
    used: set = set()
    out: list = []
    for dim, ax in zip(shape, axes):
        rule = _expand(rules.get(ax), sizes) if ax is not None else None
        if rule is None:
            out.append(None)
            continue
        mesh_axes = rule if isinstance(rule, tuple) else (rule,)
        kept = []
        size = 1
        for m in mesh_axes:
            if m not in sizes or m in used:
                continue
            if dim % (size * sizes[m]) != 0:
                continue
            kept.append(m)
            size *= sizes[m]
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
            used.add(kept[0])
        else:
            out.append(tuple(kept))
            used.update(kept)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def mentions(spec: Spec, axis: str) -> bool:
    for e in spec:
        if e == axis or (isinstance(e, tuple) and axis in e):
            return True
    return False


def placements(spec: Spec, mesh: DeviceMesh) -> Tuple[Placement, ...]:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim."""
    names = list(mesh.mesh_dim_names or ())
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"dim {dim} is split over {axes}, not in the mesh's order "
                             f"{tuple(names)}: DTensor splits a dim major to minor in mesh order")
        for i in order:
            out[i] = Shard(dim)
    return tuple(out)


def current_mesh() -> Optional[DeviceMesh]:
    """The ambient ``with mesh:`` DeviceMesh, or None (e.g. CPU smoke tests)."""
    stack = _mesh_resources.mesh_stack
    return stack[-1] if stack else None


def constrain(x: torch.Tensor, axes: Sequence[Optional[str]], rules: Optional[Dict] = None):
    """Redistribute a DTensor to its logical axes' placements; the identity
    with no ambient mesh, or for a plain tensor.

    Models call this at layer-stack boundaries (activation sequence
    sharding) and on logits (vocab sharding); the mappings drop wherever
    dims don't divide, so the same model code runs on one device and on a
    mesh (the JAX package's ``with_sharding_constraint``).
    """
    if current_mesh() is None or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    want = placements(resolve_axes(axes, x.shape, mesh, rules), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def split_heads(x: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """x (..., heads·head_dim) viewed as (..., heads, head_dim).

    A DTensor split on its last dim keeps the split where it falls on whole
    heads and is replicated on that dim first where it does not (8 KV heads
    on a 16-way model axis): DTensor cannot unflatten a dim split inside a
    head, where GSPMD reshards the reshape.  A plain tensor is only viewed.
    """
    if isinstance(x, DTensor):
        last = x.ndim - 1
        ways = math.prod(x.device_mesh.size(i) for i, p in enumerate(x.placements)
                         if p.is_shard(last))
        if heads % ways:
            x = x.redistribute(x.device_mesh, tuple(Replicate() if p.is_shard(last) else p
                                                    for p in x.placements))
    return x.reshape(*x.shape[:-1], heads, head_dim)


def gathered(x: torch.Tensor) -> torch.Tensor:
    """A DTensor replicated on every rank of its mesh (an all-gather, as GSPMD
    inserts one before an op it cannot run sharded); a plain tensor as it is.
    The model calls it where DTensor has no working rule for the op."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, (Replicate(),) * x.device_mesh.ndim)


def local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value as a plain tensor on this rank (gathered
    first); a plain tensor as it is.  Decode caches are kept so."""
    return gathered(x).to_local() if isinstance(x, DTensor) else x


def on_replicated(fn: Callable) -> Callable:
    """``fn`` run on plain tensors: its DTensor arguments gathered and
    unwrapped (:func:`local`), its tensor result wrapped back as a DTensor
    replicated on their mesh; with no DTensor argument, ``fn`` itself.  For
    a core of many small operations that DTensor cannot propagate on every
    torch release (the attention's einsums, masks and running softmax), as
    GSPMD gathers around an operation it does not partition."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        mesh = next((a.device_mesh for a in (*args, *kwargs.values())
                     if isinstance(a, DTensor)), None)
        if mesh is None:
            return fn(*args, **kwargs)
        out = fn(*map(local, args), **{k: local(v) for k, v in kwargs.items()})
        return DTensor.from_local(out, mesh, (Replicate(),) * mesh.ndim, run_check=False)
    return run


def on_batch_shards(*batched: int) -> Callable:
    """A decorator: ``fn`` run on this rank's share of the batch, as a
    ``shard_map`` over the batch axes.  The positional arguments at the
    indices ``batched`` lead with the batch dim: when one of them is a
    DTensor, each keeps only its split of dim 0 and is replicated on every
    other mesh dim (a plain one counts as replicated and is split so), the
    other DTensor arguments are replicated, and ``fn`` runs on the local
    tensors; each tensor it returns, batch first, is wrapped back as a
    DTensor split as the batch is.  The other arguments' gradients are
    partial sums over the batch's mesh dims.  For a block of operations
    that needs no collective, run locally instead of one DTensor dispatch
    each: a loop over positions or chunks, and operations some torch
    releases have no sharding rule for (``flip`` in ``cumsum``'s backward,
    the padding of a causal convolution).  With no DTensor among the
    batched arguments, ``fn`` itself."""
    def decorate(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def run(*args):
            lead = next((args[i] for i in batched if isinstance(args[i], DTensor)), None)
            if lead is None:
                return fn(*args)
            mesh = lead.device_mesh
            split = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in lead.placements)
            partial = tuple(Partial() if p.is_shard(0) else Replicate() for p in split)
            whole = (Replicate(),) * mesh.ndim

            def unwrap(i, a):
                if i in batched:
                    if not isinstance(a, DTensor):
                        a = DTensor.from_local(a, mesh, whole, run_check=False)
                    return a.redistribute(mesh, split).to_local()
                if isinstance(a, DTensor):
                    return a.redistribute(mesh, whole).to_local(grad_placements=partial)
                return a

            def wrap(t):
                if isinstance(t, torch.Tensor):
                    return DTensor.from_local(t, mesh, split, run_check=False)
                return type(t)(map(wrap, t))
            return wrap(fn(*(unwrap(i, a) for i, a in enumerate(args))))
        return run
    return decorate
