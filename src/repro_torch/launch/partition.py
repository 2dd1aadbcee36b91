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

On a mesh the models compute on each rank's shards, as GSPMD partitions
the JAX package's: :func:`on_local_shards` runs a function on the local
tensors of its arguments, placed by :func:`shards` (the batch, and a head,
expert or feature dim), with a :class:`ModelAxis` for the collectives it
needs; :func:`row_split` is an output projection's product; decode states
are placed by :func:`cache_spec`.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh, _mesh_resources
from torch.distributed.tensor import DTensor, Partial, Placement, Replicate, Shard

__all__ = ["DEFAULT_RULES", "Spec", "resolve_axes", "mesh_sizes", "placements", "mentions",
           "current_mesh", "constrain", "split_heads", "gathered", "local", "cache_spec",
           "cache_placements", "whole_grads", "row_split", "place_local", "mesh_of", "shards",
           "ModelAxis", "PLAIN", "on_local_shards"]

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


def cache_spec(shape: Sequence[int], mesh: Union[DeviceMesh, Mapping[str, int]],
               rules: Optional[Dict] = None) -> Spec:
    """The spec of one decode-state tensor (``sharding.cache_sharding_rules``'
    rule for a leaf).  Attention KV caches (B, T, KV, hd): batch over (pod,
    data); KV heads on ``model`` when divisible, else head_dim on ``model``,
    else replicated.  A 4-D or 3-D recurrent state, (B, H, N, P) or (B, H,
    P), has its dim 2 on ``model`` by the same rule; 2-D states the batch
    only."""
    if len(shape) == 4:            # (B, T, KV, hd) or (B, H, N, P)
        axes = ("batch", None, "heads", "head_dim_tp")
    elif len(shape) == 3:          # (B, H, P) / (B, conv, C)
        axes = ("batch", None, "heads")
    elif len(shape) == 2:
        axes = ("batch", None)
    else:
        axes = ("batch",) + (None,) * (len(shape) - 1)
    local_rules = {**(rules or {}), "heads": "model", "head_dim_tp": None}
    spec = resolve_axes(axes, shape, mesh, local_rules)
    if len(shape) == 4 and not mentions(spec, "model"):
        local_rules = {**(rules or {}), "heads": None, "head_dim_tp": "model"}
        spec = resolve_axes(axes, shape, mesh, local_rules)
    return spec


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
    first); a plain tensor as it is."""
    return gathered(x).to_local() if isinstance(x, DTensor) else x


def cache_placements(mesh: DeviceMesh, shape: Sequence[int]) -> Tuple[Placement, ...]:
    """The DTensor placements :func:`cache_spec` gives a decode state of
    ``shape`` on ``mesh``."""
    return placements(cache_spec(shape, mesh), mesh)


def whole_grads(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself; on a mesh its gradient is brought to ``x``'s own
    placements (summed, where it comes back a partial sum) before it flows
    on.  Models call it on the normed activations that column-split
    projections read, where Megatron's ``f`` operator all-reduces the
    gradient: DTensor would otherwise carry the partial sum back into the
    row-split projection before it and, to avoid reducing it, gather that
    projection's weight and repeat its product on every rank."""
    if not (isinstance(x, DTensor) and x.requires_grad and torch.is_grad_enabled()):
        return x
    return DTensor.from_local(x.to_local(), x.device_mesh, x.placements, run_check=False)


def row_split(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w`` for a weight whose rows (the contracted dim) the ``model``
    axis splits, as a block's output projection's: on a mesh each rank
    multiplies its columns of ``h`` by its rows of ``w`` and the partial
    products are summed over the axis in ``h``'s dtype, as XLA reduces the
    JAX package's partitioned dot; the result is split over the batch
    alone.  Plain tensors: ``h @ w``."""
    mesh = mesh_of(h, w)
    rows = None if mesh is None else shards(mesh, w.shape, batch=None, model=0)
    if mesh is None or all(p.is_replicate() for p in rows):
        return h @ w
    cols = shards(mesh, h.shape, model=h.ndim - 1)
    batch = shards(mesh, h.shape)
    partial = tuple(Partial() if r.is_shard() else b for r, b in zip(rows, batch))
    out = on_local_shards(lambda axis, h, w: h @ w, (h, w), (cols, rows), partial)
    return out.redistribute(mesh, batch)


def place_local(t: torch.Tensor, mesh: DeviceMesh, where: Sequence[Placement]) -> DTensor:
    """``t``, the same whole value on every rank, as a DTensor placed at
    ``where``: each rank keeps its own shard (a copy), with no collective."""
    whole = DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim, run_check=False)
    shard = whole.redistribute(mesh, tuple(where)).to_local().clone()
    return DTensor.from_local(shard, mesh, tuple(where), run_check=False)


def mesh_of(*xs) -> Optional[DeviceMesh]:
    """The mesh of the first DTensor among ``xs``, or None."""
    return next((x.device_mesh for x in xs if isinstance(x, DTensor)), None)


def shards(mesh: DeviceMesh, shape: Sequence[int], batch: Optional[int] = 0,
           model: Optional[int] = None) -> Tuple[Placement, ...]:
    """Placements on ``mesh`` of a tensor of ``shape``: dim ``batch`` split
    over ("pod", "data") as ``resolve_axes`` splits a batch (each axis kept
    while it divides), dim ``model`` over "model" when it divides; every
    other mesh dim replicated."""
    names = list(mesh.mesh_dim_names or ())
    sizes = mesh_sizes(mesh)
    out: list = [Replicate()] * len(names)
    if batch is not None:
        ways = 1
        for a in ("pod", "data"):
            if a in sizes and shape[batch] % (ways * sizes[a]) == 0:
                out[names.index(a)] = Shard(batch)
                ways *= sizes[a]
    if model is not None and "model" in sizes and shape[model] % sizes["model"] == 0:
        out[names.index("model")] = Shard(model)
    return tuple(out)


class ModelAxis:
    """The ``model`` mesh axis seen from inside a function that
    :func:`on_local_shards` runs on local tensors: this rank's ``index`` on
    it, its ``size``, and its collectives on tensors whose dim 0 is the
    batch, split as ``batch`` places it; and the batch's split itself
    (``batch_ways`` ranks, this one ``batch_index``, in the order of the
    batch's rows).  ``PLAIN`` (no mesh) has indices 0, sizes 1 and
    identities for collectives, so one function serves both."""

    def __init__(self, mesh: Optional[DeviceMesh] = None,
                 batch: Sequence[Placement] = ()):
        self.mesh = mesh
        names = list(mesh.mesh_dim_names or ()) if mesh is not None else []
        self.dim = names.index("model") if "model" in names else None
        self.size = mesh.size(self.dim) if self.dim is not None else 1
        self.index = mesh.get_local_rank(self.dim) if self.size > 1 else 0
        # the batch's placements with the model dim replicated
        self._rest = tuple(Replicate() if i == self.dim else p for i, p in enumerate(batch))
        self.batch_ways, self.batch_index = 1, 0
        for i, p in enumerate(self._rest):          # major to minor, as DTensor splits
            if p.is_shard(0):
                self.batch_ways *= mesh.size(i)
                self.batch_index = self.batch_index * mesh.size(i) + mesh.get_local_rank(i)

    def stack_batch(self, t: torch.Tensor) -> torch.Tensor:
        """Every batch shard's ``t`` stacked in the batch's order: (batch_ways,
        *t.shape), the same on every rank (an all-gather)."""
        if self.batch_ways == 1:
            return t[None]
        d = DTensor.from_local(t[None], self.mesh, self._rest, run_check=False)
        return d.redistribute(self.mesh, (Replicate(),) * self.mesh.ndim).to_local()

    def _over_batch(self, p: Placement) -> Tuple[Placement, ...]:
        return tuple(p if q.is_shard(0) else Replicate() for q in self._rest)

    def scatter_batch(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The sum of every batch shard's ``t``, each keeping its own split
        of ``dim`` (a reduce-scatter over the batch's ranks)."""
        if self.batch_ways == 1:
            return t
        d = DTensor.from_local(t, self.mesh, self._over_batch(Partial()), run_check=False)
        return d.redistribute(self.mesh, self._over_batch(Shard(dim))).to_local()

    def join_batch(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every batch shard's split of ``dim`` joined (the all-gather that
        undoes :meth:`scatter_batch`'s split).  Each rank may read its own
        part of the result, so the gradient is summed over the batch's
        ranks (a reduce-scatter)."""
        if self.batch_ways == 1:
            return t
        d = DTensor.from_local(t, self.mesh, self._over_batch(Shard(dim)), run_check=False)
        return d.redistribute(self.mesh, self._over_batch(Replicate())).to_local(
            grad_placements=self._over_batch(Partial()))

    def span(self, n: int, split: bool = True) -> Tuple[int, int]:
        """This rank's [start, stop) of ``n`` items split evenly over the
        axis (all of them when not ``split``)."""
        if not split or self.size == 1:
            return 0, n
        part = n // self.size
        return self.index * part, (self.index + 1) * part

    def _with(self, p: Placement) -> Tuple[Placement, ...]:
        return tuple(p if i == self.dim else q for i, q in enumerate(self._rest))

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the axis of each rank's ``t`` (an all-reduce)."""
        if self.size == 1:
            return t
        d = DTensor.from_local(t, self.mesh, self._with(Partial()), run_check=False)
        return d.redistribute(self.mesh, self._rest).to_local()

    def scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The sum over the axis of each rank's ``t``, each rank keeping its
        split of ``dim`` (a reduce-scatter)."""
        if self.size == 1:
            return t
        d = DTensor.from_local(t, self.mesh, self._with(Partial()), run_check=False)
        return d.redistribute(self.mesh, self._with(Shard(dim))).to_local()

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Each rank's ``t`` joined along ``dim`` in rank order (an
        all-gather)."""
        if self.size == 1:
            return t
        d = DTensor.from_local(t, self.mesh, self._with(Shard(dim)), run_check=False)
        return d.redistribute(self.mesh, self._rest).to_local()


PLAIN = ModelAxis()


def on_local_shards(fn: Callable, args: Sequence, where: Sequence, out: Union[Sequence, Placement,
                                                                          None],
                    batch: Optional[Sequence[Placement]] = None):
    """``fn(axis, *locals)`` run on each rank's shards, as a ``shard_map``
    over the batch and a head, expert or feature dim.

    ``where[i]`` places ``args[i]`` before the call: a tuple of placements
    (the argument, a plain tensor counted as replicated, is redistributed
    there and handed over as its local tensor) or None (handed over as it
    is).  ``out`` places what ``fn`` returns, a tensor or a tuple of them
    (a tuple of placements each, or None for a value handed back as it
    is), as DTensors on the same mesh: ``Partial()`` where each rank holds
    a partial sum.  An argument's gradient is a partial sum over every mesh
    dim that splits the computation (a dim that some argument or result is
    not replicated on) and that the argument is replicated on.  ``axis`` is the
    :class:`ModelAxis` of the batch placements ``batch`` (by default the
    first placed argument's, batch on dim 0).  With no DTensor among the
    placed arguments, ``fn(PLAIN, *args)``: the plain path, untouched.
    """
    mesh = mesh_of(*(a for a, w in zip(args, where) if w is not None))
    if mesh is None:
        return fn(PLAIN, *args)
    placed = [w for w in where if w is not None]

    def leaves(w) -> list:      # the placement tuples of a (nested) ``out``
        if w is None:
            return []
        if isinstance(w[0], Placement):
            return [w]
        return [x for v in w for x in leaves(v)]

    split = {i for w in placed + leaves(out) for i, p in enumerate(w) if not p.is_replicate()}

    def unwrap(a, w):
        if w is None:
            return a
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, (Replicate(),) * mesh.ndim, run_check=False)
        grad = tuple(Partial() if i in split and p.is_replicate() else p
                     for i, p in enumerate(w))
        return a.redistribute(mesh, tuple(w)).to_local(grad_placements=grad)

    if batch is None:
        batch = tuple(p if p.is_shard(0) else Replicate() for p in placed[0])
    result = fn(ModelAxis(mesh, batch), *(unwrap(a, w) for a, w in zip(args, where)))

    def wrap(t, w):
        if w is None or t is None:
            return t
        if isinstance(t, (tuple, list)):
            return type(t)(wrap(x, v) for x, v in zip(t, w, strict=True))
        return DTensor.from_local(t, mesh, tuple(w), run_check=False)

    return wrap(result, out)
