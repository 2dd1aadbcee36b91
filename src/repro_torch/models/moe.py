"""Top-k Mixture-of-Experts block (Mixtral / Phi-3.5 style), on PyTorch.

The port of the JAX package's ``models/moe.py``, with its GShard
semantics: float32 router logits; softmax, then top-k, then the gates
renormalised; a capacity of ``max(ceil(T·k/E·moe_capacity_factor), 4)``
slots per expert; a (token, slot) pair's place in its expert's buffer is
the count of earlier pairs routed there in the token-major ``(T·k, E)``
order (slot 1 of token 0 precedes slot 0 of token 1); pairs at or past
capacity are dropped; a sequence longer than ``MOE_SEGMENT`` is routed in
segments of the largest divisor of S that is at most ``MOE_SEGMENT``, each
with its own capacity.

The JAX package dispatches and combines with one-hot einsums.  The port
does the same work by index: each kept pair's token row is copied into its
``(E, C, d)`` buffer slot, the experts run as batched matmuls over all E
(as in the JAX package: every expert's weights are read), and each pair's
gated expert output is added back to its token with ``index_add_``.  A
dropped pair writes to, and reads from, one spare row past the buffers, so
nothing on the path syncs with the host (no ``.item()``, no
``.nonzero()``).

On a mesh each rank routes its own batch shard, with each pair's place in
its expert's buffer counted over the whole dispatch group (the pairs of the
shards before it added from a gather of each shard's count per expert), so
capacity and drops are the unsharded block's.  It fills only the slots of
its own tokens and runs its experts (``expert`` on the model axis) or its
columns of every expert's FFN (``mlp`` on it); its combine is a partial sum
over the model axis, which DTensor reduces.  Serving, each rank runs the
whole buffer (the other shards' slots empty, their outputs unread), as
GSPMD partitions the JAX package's serving steps; training (grad
enabled), the buffers of the batch's ranks are summed and split over the
capacity (a reduce-scatter), each rank runs its split and the outputs are
joined again (an all-gather), as GSPMD partitions its train step, so no
batch rank repeats another's FFN.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.partition import PLAIN, ModelAxis, mesh_of, on_local_shards, shards
from repro_torch.models.layers import gelu_tanh, silu
from repro_torch.models.params import ParamSpec

__all__ = ["MOE_SEGMENT", "moe_specs", "moe_apply", "route", "capacity", "load_balancing_loss"]

Params = Mapping[str, torch.Tensor]

MOE_SEGMENT = 512   # max sequence positions routed per dispatch group


def moe_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    specs = {
        "router": ParamSpec((d, e), ("embed", "unsharded"), torch.float32,
                            init="scaled_normal"),
    }
    if cfg.mlp_type in ("swiglu", "geglu"):
        specs.update({
            "wg": ParamSpec((e, d, f), ("expert", "embed", "mlp"), init="scaled_normal"),
            "wu": ParamSpec((e, d, f), ("expert", "embed", "mlp"), init="scaled_normal"),
            "wd": ParamSpec((e, f, d), ("expert", "mlp", "embed"), init="scaled_normal"),
        })
    else:
        specs.update({
            "wi": ParamSpec((e, d, f), ("expert", "embed", "mlp"), init="scaled_normal"),
            "wd": ParamSpec((e, f, d), ("expert", "mlp", "embed"), init="scaled_normal"),
        })
    return specs


def moe_apply(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d), top-k routed experts with capacity, in
    segments of at most ``MOE_SEGMENT`` positions."""
    names = ["router"] + [k for k in ("wg", "wu", "wi", "wd") if k in p]
    mesh = mesh_of(x, *(p[k] for k in names))
    if mesh is None:
        return _moe_segments(PLAIN, x, cfg, None, **p)
    axis = ModelAxis(mesh)
    e, f = cfg.num_experts, cfg.d_ff
    split = None
    if axis.size > 1:
        split = "expert" if e % axis.size == 0 else "mlp" if f % axis.size == 0 else None
    dims = {"expert": {"wg": 0, "wu": 0, "wi": 0, "wd": 0},
            "mlp": {"wg": 2, "wu": 2, "wi": 2, "wd": 1}}.get(split, {})
    batch = shards(mesh, x.shape)
    where = [batch] + [shards(mesh, p[k].shape, batch=None, model=dims.get(k)) for k in names]
    out = tuple(Partial() if split and i == axis.dim else b for i, b in enumerate(batch))
    y = on_local_shards(
        lambda ax, x, *w: _moe_segments(ax, x, cfg, split, **dict(zip(names, w))),
        [x] + [p[k] for k in names], where, out)
    return y.redistribute(mesh, batch).to(x.dtype)


def _moe_segments(axis: ModelAxis, x: torch.Tensor, cfg: ArchConfig, split, **p
                  ) -> torch.Tensor:
    b, s, d = x.shape
    if s <= MOE_SEGMENT:
        return _moe_dispatch(p, x, cfg, axis, split)
    seg = MOE_SEGMENT
    while s % seg:
        seg -= 1
    return torch.cat([_moe_dispatch(p, x[:, i:i + seg], cfg, axis, split)
                      for i in range(0, s, seg)], dim=1)


def route(p: Params, xf: torch.Tensor, cfg: ArchConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router on tokens xf (T, d): (gates (T, E) float32, the top-k
    gates renormalised (T, k), their experts (T, k)), each token's experts
    in descending gate order."""
    gates = torch.softmax(xf.float() @ p["router"], dim=-1)
    topk_g, topk_i = torch.topk(gates, cfg.experts_per_token, dim=-1)
    topk_g = topk_g / torch.clamp_min(topk_g.sum(-1, keepdim=True), 1e-9)
    return gates, topk_g, topk_i


def capacity(tokens: int, cfg: ArchConfig) -> int:
    """Slots per expert for a dispatch group of ``tokens`` tokens."""
    k, e = cfg.experts_per_token, cfg.num_experts
    return max(math.ceil(tokens * k / e * cfg.moe_capacity_factor), 4)


def _moe_dispatch(p: Params, x: torch.Tensor, cfg: ArchConfig, axis: ModelAxis = PLAIN,
                  split=None) -> torch.Tensor:
    """One dispatch group on this rank's tokens x (B, S, d).  On a mesh
    (``axis``, ``split`` as in :func:`moe_apply`) it returns this rank's
    float32 partial sum of the combine; plain, the block's output."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    tokens = b * s
    xf = x.reshape(tokens, d)
    _, topk_g, topk_i = route(p, xf, cfg)
    cap = capacity(tokens * axis.batch_ways, cfg)
    by_capacity = axis.batch_ways > 1 and torch.is_grad_enabled()
    if by_capacity:              # slots up to a multiple of the batch's ranks, never filled
        cap_buf = -(-cap // axis.batch_ways) * axis.batch_ways
    else:
        cap_buf = cap

    # position of each (token, slot) within its expert's capacity buffer:
    # the pairs routed to the same expert before it, token-major
    expert = topk_i.reshape(-1)                                   # (T*k,)
    onehot = F.one_hot(expert, e)                                 # (T*k, E)
    pos = (torch.cumsum(onehot, dim=0) - onehot).gather(1, expert[:, None])[:, 0]
    if axis.batch_ways > 1:      # the pairs of the batch shards before this one
        before = axis.stack_batch(onehot.sum(0))[:axis.batch_index].sum(0)
        pos = pos + before[expert]
    keep = pos < cap
    e0, e1 = axis.span(e, split == "expert")
    if (e0, e1) != (0, e):       # this rank's experts alone
        keep = keep & (expert >= e0) & (expert < e1)
        expert = expert - e0
    spare = (e1 - e0) * cap_buf                                   # the dropped pairs' row
    slot = torch.where(keep, expert * cap_buf + pos, torch.full_like(pos, spare))
    token = torch.arange(tokens, device=x.device).repeat_interleave(k)

    buf = x.new_zeros(spare + 1, d)
    buf.index_copy_(0, slot, xf[token])             # a kept pair fills its slot alone
    expert_in = buf[:spare].view(e1 - e0, cap_buf, d)
    if by_capacity:
        expert_in = axis.scatter_batch(expert_in, 1)
    if cfg.mlp_type in ("swiglu", "geglu"):
        gate = torch.bmm(expert_in, p["wg"])
        gate = silu(gate) if cfg.mlp_type == "swiglu" else gelu_tanh(gate)
        h = gate * torch.bmm(expert_in, p["wu"])
    else:
        h = gelu_tanh(torch.bmm(expert_in, p["wi"]))
    expert_out = torch.bmm(h, p["wd"])
    if by_capacity:
        expert_out = axis.join_batch(expert_out, 1)
    expert_out = torch.cat([expert_out.reshape(spare, d), x.new_zeros(1, d)])

    # combine: each pair's gated output onto its token, in float32
    g = torch.where(keep, topk_g.reshape(-1).to(x.dtype), torch.zeros((), dtype=x.dtype,
                                                                      device=x.device))
    out = torch.zeros(tokens, d, dtype=torch.float32, device=x.device)
    out.index_add_(0, token, expert_out[slot].float() * g.float()[:, None])
    if axis.mesh is not None:
        return out.view(b, s, d)
    return out.to(x.dtype).view(b, s, d)


def load_balancing_loss(p: Params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Switch-style aux loss: E · Σ_e f_e · P_e (mean gate × token fraction)."""
    d = x.shape[-1]
    gates = torch.softmax(x.reshape(-1, d).float() @ p["router"], dim=-1)
    top1 = torch.argmax(gates, dim=-1)
    frac = F.one_hot(top1, cfg.num_experts).float().mean(0)
    return cfg.num_experts * torch.sum(frac * gates.mean(0))
