"""train_step / serve_step builders + abstract input specs per (arch, shape).

The port of the JAX package's ``launch/steps.py``.  Everything here is
shape-only until the caller builds a real model: ``abstract_inputs``
returns ``meta`` tensors (the JAX package's ``ShapeDtypeStruct``s, no
allocation) and the ``*_shardings`` the matching
:class:`~repro_torch.launch.sharding.NamedSharding`s.

The step builders take the port's module where the JAX package's take a
``params`` tree: the module holds its parameters, and the train step
writes the parameters and the optimizer's state in place, as the port's
optimizers do.  Each step runs under DTensor's ``implicit_replication``:
the plain tensors the model makes on the fly (rope tables, masks,
positions) count as replicated on a mesh, as GSPMD treats constants.  :func:`shard_model` places a module's parameters on a
mesh as DTensors, by :func:`train_state_shardings`' rules.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication
from torch.nn.utils.stateless import _reparametrize_module

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.convert import group
from repro_torch.launch import sharding as SH
from repro_torch.launch.partition import (gathered, local, mesh_sizes, on_local_shards,
                                          place_local, shards)
from repro_torch.models import build_model
from repro_torch.models.params import abstract, tree_bytes
from repro_torch.optim.optimizer import Optimizer, make_optimizer

__all__ = ["build_train_step", "build_prefill_step", "build_decode_step",
           "abstract_inputs", "abstract_train_state", "train_state_shardings",
           "input_shardings", "grad_accum_for", "enc_len_for", "serve_rules", "shard_model"]


# ---------------------------------------------------------------------------
# Input specs (meta-tensor stand-ins)
# ---------------------------------------------------------------------------

def enc_len_for(cfg: ArchConfig, shape: ShapeConfig) -> int:
    """Encoder length for enc-dec archs: half the cell's token budget."""
    return shape.seq_len // 2


def grad_accum_for(cfg: ArchConfig, shape: ShapeConfig, mesh=None) -> int:
    """Microbatch count: honor cfg but keep microbatch divisible by DP.

    ``REPRO_GRAD_ACCUM`` (the JAX package's variable) overrides ``cfg`` for
    perf experiments.  ``mesh``: a DeviceMesh, a mapping of axis name to
    size, or None (no data parallelism).
    """
    accum = int(os.environ.get("REPRO_GRAD_ACCUM", "0")) or max(1, cfg.grad_accum_train)
    dp = 1
    if mesh is not None:
        sizes = mesh_sizes(mesh)
        for a in ("pod", "data"):
            dp *= sizes.get(a, 1)
    while accum > 1 and (shape.global_batch % accum
                         or (shape.global_batch // accum) % dp):
        accum //= 2
    return max(accum, 1)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def abstract_inputs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The batch of one cell as ``meta`` tensors (tokens int32, as in JAX)."""
    b, s = shape.global_batch, shape.seq_len
    tok = torch.int32
    if shape.kind in ("train", "prefill"):
        if cfg.is_encdec:
            e = enc_len_for(cfg, shape)
            out = {"frames": _meta((b, e, cfg.frontend_dim), torch.bfloat16),
                   "tokens": _meta((b, s - e), tok)}
            if shape.kind == "train":
                out["labels"] = _meta((b, s - e), tok)
            return out
        out = {"tokens": _meta((b, s), tok)}
        if shape.kind == "train":
            out["labels"] = _meta((b, s), tok)
        if cfg.frontend == "vit_stub":
            out["image_embeds"] = _meta((b, cfg.frontend_tokens, cfg.frontend_dim),
                                        torch.bfloat16)
        return out
    # decode: one token + caches + position
    model = build_model(cfg, device="meta")
    if cfg.is_encdec:
        caches = model.init_cache(b, s, enc_len=enc_len_for(cfg, shape))
    else:
        caches = model.init_cache(b, s)
    return {"token": _meta((b, 1), tok), "caches": caches, "pos": _meta((), torch.int32)}


def input_shardings(cfg: ArchConfig, shape: ShapeConfig, mesh: DeviceMesh,
                    rules: Optional[Dict] = None) -> Dict[str, Any]:
    """NamedShardings matching abstract_inputs."""
    specs = abstract_inputs(cfg, shape)
    out: Dict[str, Any] = {}
    for k, v in specs.items():
        if k == "caches":
            out[k] = SH.cache_sharding_rules(mesh, v, rules)
        elif k == "pos":
            out[k] = SH.NamedSharding(mesh, ())
        else:
            out[k] = SH.batch_shardings(mesh, v, rules)
    return out


# ---------------------------------------------------------------------------
# Train state
# ---------------------------------------------------------------------------

def serve_rules(cfg: ArchConfig, tp: int = 16, hbm_budget: float = 8e9) -> Dict:
    """Inference sharding override: TP-only weights when they fit.

    FSDP-sharded weights must be all-gathered across the data axis for
    every decoded token; with TP-only sharding the weights are replicated
    across data and the decode step runs gather-free.  Falls back to FSDP
    for archs whose per-rank TP-sharded weights exceed the memory budget.
    """
    per_rank = tree_bytes(build_model(cfg, device="meta").specs()) / tp
    if per_rank <= hbm_budget:
        return {"embed": None}          # drop the FSDP mapping
    return {}


def _named(tree, prefix: str = "") -> Dict[str, Any]:
    """A tree of dicts and lists flattened to {dotted name: leaf}, the
    module's ``named_parameters()`` names for its spec tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(_named(v, f"{prefix}{k}."))
    return out


def _state_specs(model, opt: Optimizer):
    """The optimizer state's spec tree, keyed as ``opt.init`` keys it: by
    the JAX package's leaf, stacked layers on a leading ``"layers"`` axis."""
    return opt.state_specs(group(_named(model.specs()), model))


def abstract_train_state(cfg: ArchConfig) -> Tuple[Any, Any, Optimizer]:
    """(abstract params, abstract opt state, optimizer)."""
    model = build_model(cfg, device="meta")
    opt = make_optimizer(cfg.optimizer, lr=1e-4)
    return abstract(model.specs()), abstract(_state_specs(model, opt)), opt


def train_state_shardings(cfg: ArchConfig, mesh: DeviceMesh, rules: Optional[Dict] = None):
    """(the parameters' NamedSharding tree, the optimizer state's)."""
    model = build_model(cfg, device="meta")
    opt = make_optimizer(cfg.optimizer, lr=1e-4)
    return (SH.param_shardings(model.specs(), mesh, rules),
            SH.param_shardings(_state_specs(model, opt), mesh, rules))


def shard_model(model: nn.Module, mesh: DeviceMesh, rules: Optional[Dict] = None) -> nn.Module:
    """Replace every parameter of ``model`` by a DTensor placed by
    :func:`train_state_shardings`' parameter rules, in place; returns
    ``model``.  Every rank holds the same weights (the same seed, or the
    same checkpoint) and keeps its own shard of each, with no collective
    (:func:`~repro_torch.launch.partition.place_local`)."""
    shardings = _named(SH.param_shardings(model.specs(), mesh, rules))
    for name, p in list(model.named_parameters()):
        parent, _, attr = name.rpartition(".")
        sh = shardings[name]
        placed = place_local(p.detach(), mesh, sh.placements)
        setattr(model.get_submodule(parent), attr,
                nn.Parameter(placed, requires_grad=p.requires_grad))
    return model


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def _gathered_over_batch(model: nn.Module):
    """A context in which ``model``'s DTensor parameters are gathered over
    the batch axes ("pod", "data") and keep their ``model`` split, as FSDP
    gathers each weight before a microbatch's forward; their gradients flow
    back to the sharded parameters (a reduce-scatter).  For plain
    parameters, nothing.  A context and not ``torch.func.functional_call``,
    which restores the parameters when the forward returns: the backward's
    checkpointed recompute reads them again and must see the gathered ones."""
    placed = {}
    for name, p in model.named_parameters():
        if isinstance(p, DTensor):
            names = p.device_mesh.mesh_dim_names or ()
            placed[name] = p.redistribute(p.device_mesh, tuple(
                Replicate() if names[i] in ("pod", "data") else q
                for i, q in enumerate(p.placements)))
    return _reparametrize_module(model, placed) if placed else contextlib.nullcontext()


def build_train_step(cfg: ArchConfig, shape: ShapeConfig, mesh=None,
                     opt: Optional[Optimizer] = None):
    """Returns ``train_step(model, opt_state, step, batch) -> metrics`` with
    microbatched gradient accumulation; the parameters and ``opt_state``
    are updated in place.

    The batch is split into ``accum`` microbatches as the JAX package
    splits it (``x.reshape(accum, B / accum, …)``); gradients accumulate in
    float32 and are divided by ``accum``; metrics are the mean loss and
    the float32 norm of the averaged gradients.  On a mesh each
    microbatch's forward runs on the weights gathered over the batch axes
    (:func:`_gathered_over_batch`): DTensor would otherwise gather a small
    microbatch's activations instead and repeat its work on every batch
    rank.
    """
    opt = opt or make_optimizer(cfg.optimizer, lr=1e-4)
    accum = grad_accum_for(cfg, shape, mesh)

    @implicit_replication()
    def train_step(model, opt_state, step: int, batch: Dict[str, torch.Tensor]):
        names = [n for n, _ in model.named_parameters()]
        params = [p for _, p in model.named_parameters()]
        # DTensor cannot split a batch dim sharded over (pod, data) into
        # (accum, B / accum) (GSPMD reshards the reshape): the microbatches
        # come from the gathered batch, and the model shards each again
        mbs = {k: (gathered(v) if accum > 1 else v).reshape(
                   (accum, v.shape[0] // accum) + tuple(v.shape[1:]))
               for k, v in batch.items()}
        acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        loss_sum = None
        for i in range(accum):
            with _gathered_over_batch(model):      # the remat's recompute too
                loss = model.loss_fn({k: v[i] for k, v in mbs.items()})
                grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                for a, g in zip(acc, grads):
                    a.add_(g.float())
            del grads
            loss = loss.detach().float()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        with torch.no_grad():
            for a in acc:
                a.div_(accum)
            gnorm = torch.sqrt(sum(local(torch.sum(a * a)) for a in acc))
            opt.update(group(dict(zip(names, acc)), model), opt_state,
                       group(dict(zip(names, params)), model), step)
        return {"loss": local(loss_sum / accum), "grad_norm": gnorm}

    return train_step


def build_prefill_step(cfg: ArchConfig):
    """Returns ``prefill_step(model, batch, max_seq=None) -> (last-position
    logits, caches)``; ``max_seq`` sizes the attention caches for decoding
    on (the JAX package's step always takes the prompt's length, the
    dry-run's shape).  On a mesh the caches are DTensors placed by
    :func:`~repro_torch.launch.sharding.cache_sharding_rules`, as
    :func:`input_shardings` places a decode step's."""
    if cfg.is_encdec:
        @implicit_replication()
        def prefill_step(model, batch, max_seq=None):
            return model.prefill(batch["frames"], batch["tokens"], max_seq=max_seq)
    elif cfg.frontend == "vit_stub":
        @implicit_replication()
        def prefill_step(model, batch, max_seq=None):
            return model.prefill(batch["tokens"], image_embeds=batch["image_embeds"],
                                 max_seq=max_seq)
    else:
        @implicit_replication()
        def prefill_step(model, batch, max_seq=None):
            return model.prefill(batch["tokens"], max_seq=max_seq)
    return prefill_step


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """The argmax over the vocabulary of logits (B, V), as (B, 1) int32.  On
    a mesh whose model axis splits the vocabulary each rank takes the best
    of its own columns and the best of those is chosen over the axis, the
    lowest index on a tie, as ``torch.argmax`` chooses."""
    if not isinstance(logits, DTensor):
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    mesh, vocab = logits.device_mesh, logits.shape[-1]
    batch = shards(mesh, logits.shape)
    cols = shards(mesh, logits.shape, model=1)

    def best(axis, lg):
        val, idx = lg.max(dim=-1, keepdim=True)
        if lg.shape[-1] == vocab:
            return idx.to(torch.int32)
        vals, idxs = axis.gather(val, 1), axis.gather(idx + axis.span(vocab)[0], 1)
        return idxs.gather(1, vals.argmax(dim=-1, keepdim=True)).to(torch.int32)

    return on_local_shards(best, (logits,), (cols,), batch)


def build_decode_step(cfg: ArchConfig):
    """Returns ``decode_step(model, batch) -> (next token (B, 1) int32,
    caches)``: one greedy step; the caches are updated in place, as
    ``decode_step`` updates them, and on a mesh keep their placements."""
    @implicit_replication()
    def decode_step(model, batch):
        logits, caches = model.decode_step(batch["token"], batch["caches"], int(batch["pos"]))
        # greedy next token, ready for the next iteration
        return greedy(logits), caches
    return decode_step
