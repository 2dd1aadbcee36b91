"""Roofline terms of one step, counted on the ranks that run it.

The port of the JAX package's ``launch/roofline.py``.  Terms per (arch ×
shape × mesh), all per chip, in seconds:

* compute    = FLOPs / peak FLOP/s
* memory     = dot bytes / HBM bytes/s
* collective = collective bytes / link bytes/s

The JAX package reads these off a compiled program (``cost_analysis`` and
the HLO text, with the trip counts of its ``while`` loops).  The port runs
the step eagerly, once, under :class:`StepCounter`, a
``TorchDispatchMode`` that sees the tensors one rank holds:

* an operation on DTensors is handed back to DTensor (``NotImplemented``),
  which redistributes its operands and runs the local operation on this
  rank's shards; the counter sees that local operation, and the
  ``_c10d_functional`` collectives that the redistribution issues;
* ``flops`` sums the FLOPs of every matmul-family operation
  (``torch.utils.flop_counter``'s formulas: ``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, the SDPA operations and what ``einsum`` and ``matmul`` lower
  to), 2·m·n·k for a product; ``dot_bytes`` sums each such operation's
  operands and result, the lower bound on HBM traffic that the JAX
  package's ``hlo_cost`` takes;
* every executed collective is recorded with its kind, the size of its
  group and the bytes of its per-rank result; :func:`collective_bytes`
  turns that record into bytes received per chip on a ring;
* the operations that DTensor runs on ``FakeTensor``s to propagate shapes
  are not counted.

A loop is counted once for each time it runs, since every iteration runs:
the trip-count walk of the JAX package has no counterpart.  The counter
also tracks the bytes of the storages that the step allocates and frees,
for the dry-run's memory (``launch/dryrun.py``).

Hardware constants: :data:`H100`, NVIDIA's data sheet for the H100 SXM5
80 GB at its 700 W power limit, not measurements.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode, is_traceable_wrapper_subclass
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary, WeakIdRef

__all__ = ["HW", "H100", "Collective", "StepCounter", "step_cost", "collective_bytes",
           "roofline_terms", "model_flops", "RooflineResult"]


@dataclasses.dataclass(frozen=True)
class HW:
    """One chip's peak rates and memory (per chip, per direction)."""

    name: str
    peak_flops: float        # dense bf16 FLOP/s
    hbm_bw: float            # bytes/s
    link_bw: float           # bytes/s of the collective link, per direction
    hbm_per_chip: float      # bytes


# NVIDIA H100 SXM5 80 GB, 700 W (data sheet): 989 TFLOP/s dense bf16 on the
# tensor cores, 3.35 TB/s of HBM3, 80 GB.  The collective link is one
# 400 Gb/s NDR InfiniBand port per GPU, 50 GB/s per direction: the per-chip
# worst case across nodes (NVLink inside a node is faster), as the JAX
# package takes one ICI link as its worst case.
H100 = HW(name="NVIDIA H100 SXM5 80GB, 700 W (data sheet)", peak_flops=989e12,
          hbm_bw=3.35e12, link_bw=50e9, hbm_per_chip=80e9)


def _ring_factor(kind: str, k: int, result_bytes: int) -> float:
    """Bytes received per chip on a ring realization of the collective,
    given the op's per-device *result* bytes."""
    if k <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * (k - 1) / k * result_bytes
    if kind == "all-gather":
        return (k - 1) / k * result_bytes          # result = gathered size
    if kind == "reduce-scatter":
        return (k - 1) * result_bytes               # result = one shard
    if kind == "all-to-all":
        return (k - 1) / k * result_bytes
    if kind == "collective-permute":
        return float(result_bytes)
    return float(result_bytes)


@dataclasses.dataclass(frozen=True)
class Collective:
    """One executed collective: its kind (the JAX package's names), the
    size of its group and the bytes of its result on this rank."""

    kind: str
    group_size: int
    result_bytes: int


# _c10d_functional op -> kind; the coalesced variants sum their results
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "collective-permute",
}


def collective_bytes(record: List[Collective]) -> Dict[str, float]:
    """Per-kind executed collective traffic (bytes received per chip): each
    collective's result bytes through :func:`_ring_factor`."""
    out: Dict[str, float] = {}
    for c in record:
        out[c.kind] = out.get(c.kind, 0.0) + _ring_factor(c.kind, c.group_size, c.result_bytes)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storages(t) -> list:
    """The storages that hold a plain tensor or a wrapper subclass's
    (e.g. an ``AsyncCollectiveTensor``'s) inner tensors."""
    if not isinstance(t, torch.Tensor) or isinstance(t, DTensor):
        return []
    if is_traceable_wrapper_subclass(t):
        return [st for name in t.__tensor_flatten__()[0] for st in _storages(getattr(t, name))]
    return [t.untyped_storage()]


class StepCounter(TorchDispatchMode):
    """FLOPs, dot bytes, collectives and live storage bytes of what runs
    under it, on the tensors this rank holds (the module's docstring).

    ``group_sizes``: {process group name: size}, e.g. from a mesh's
    dimensions; a group not in it is asked its size.  With ``memory``,
    ``live_bytes`` and ``peak_bytes`` count the storages that operations
    under the counter allocated and that are still referenced, and their
    peak.
    """

    def __init__(self, group_sizes: Optional[Dict[str, int]] = None, memory: bool = True):
        super().__init__()
        self.group_sizes = dict(group_sizes or {})
        self.memory = memory
        self.flops = 0.0
        self.dot_bytes = 0.0
        self.collectives: List[Collective] = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._tracked = WeakIdKeyDictionary()

    def _group_size(self, name: str) -> int:
        if name not in self.group_sizes:
            self.group_sizes[name] = dist.distributed_c10d._resolve_process_group(name).size()
        return self.group_sizes[name]

    def _track(self, out, inputs) -> None:
        """Count the storages of ``out`` that no input holds (not a view
        and not an in-place result) until they are freed."""
        held = {id(st) for t in inputs for st in _storages(t)}
        for st in (st for t in tree_flatten(out)[0] for st in _storages(t)):
            if id(st) in held or st in self._tracked:
                continue
            n = st.nbytes()
            # the reference keeps the callback alive as long as the storage
            self._tracked[st] = WeakIdRef(st, self._freed(n))
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _freed(self, n: int) -> Callable:
        def callback(_ref) -> None:
            self.live_bytes -= n
        return callback

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented            # DTensor runs the local op, which comes back here
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out                       # DTensor's shape propagation on FakeTensors
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
            self.dot_bytes += sum(_nbytes(t) for t in tree_flatten((args, kwargs, out))[0]
                                  if isinstance(t, torch.Tensor))
        elif func.namespace == "_c10d_functional":
            if packet.__name__ not in _COLLECTIVES:
                return out                   # wait_tensor and the like: the result's alias
            group = args[-1] if isinstance(args[-1], str) else kwargs["group_name"]
            self.collectives.append(Collective(_COLLECTIVES[packet.__name__],
                                               self._group_size(group),
                                               sum(_nbytes(t) for t in tree_flatten(out)[0])))
        if self.memory:
            self._track(out, tree_flatten((args, kwargs))[0])
        return out


def step_cost(fn: Callable, *args, group_sizes: Optional[Dict[str, int]] = None,
              **kwargs) -> Tuple[float, float]:
    """Per-chip ``(flops, dot_bytes)`` of ``fn(*args, **kwargs)``, run once
    under a :class:`StepCounter` (for its collectives and memory, use the
    counter itself)."""
    with StepCounter(group_sizes, memory=False) as counter:
        fn(*args, **kwargs)
    return counter.flops, counter.dot_bytes


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) for training,
    2·N·D for inference, D = processed tokens."""
    from repro_torch.models import build_model
    from repro_torch.models.params import param_count

    n_total = param_count(build_model(cfg, device="meta").specs())
    if cfg.num_experts:
        # active params: replace E experts by top-k in the MoE blocks
        moe_frac = (cfg.num_experts - cfg.experts_per_token) / cfg.num_experts
        # expert params per layer ≈ 3·d·ff (glu) or 2·d·ff
        mats = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
        expert_params = cfg.num_layers * cfg.num_experts * mats * cfg.d_model * cfg.d_ff
        n_active = n_total - moe_frac * expert_params
    else:
        n_active = n_total
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch      # one token per sequence


@dataclasses.dataclass
class RooflineResult:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_breakdown: Dict[str, int]
    peak_mem_per_chip: float
    model_flops_total: float
    hw: HW = H100

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / self.hw.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / self.hw.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_chip / self.hw.link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / (chips × counted FLOPs) — remat/redundancy waste."""
        return self.model_flops_total / max(self.flops_per_chip * self.chips, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute fraction of the bound: how close the *model* math
        comes to the chip's peak under this program = MFU upper bound."""
        t_model = self.model_flops_total / (self.chips * self.hw.peak_flops)
        return t_model / max(self.bound_time, 1e-30)

    def to_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "coll_breakdown": self.coll_breakdown,
            "peak_mem_per_chip": self.peak_mem_per_chip,
            "model_flops_total": self.model_flops_total,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "dominant": self.dominant,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
        }


def roofline_terms(arch: str, shape_name: str, mesh_name: str, chips: int, cost: Dict,
                   collectives: List[Collective], peak_mem: float, mf: float,
                   hw: HW = H100) -> RooflineResult:
    """``cost``: {"flops", "bytes accessed"} per chip (the counter's FLOPs
    and dot bytes); ``collectives``: the counter's record."""
    coll = collective_bytes(collectives)
    return RooflineResult(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        flops_per_chip=float(cost.get("flops", 0.0)),
        bytes_per_chip=float(cost.get("bytes accessed", 0.0)),
        coll_bytes_per_chip=float(sum(coll.values())),
        coll_breakdown={k: int(v) for k, v in coll.items()},
        peak_mem_per_chip=peak_mem, model_flops_total=mf, hw=hw)
