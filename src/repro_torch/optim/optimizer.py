"""Optimizers on PyTorch: AdamW, Adafactor (factored second moment), momentum
SGD.

The port of the JAX package's ``optim/optimizer.py``.  Each optimizer
exposes:

* ``init(params)``        — the state: {key: {"_s_...": float32 tensor}};
* ``state_specs(specs)``  — a ParamSpec tree mirroring ``init`` (a list of
  specs is a stacked group), so that the state can be counted without
  allocating;
* ``update(grads, state, params, step)`` — writes the new parameters and
  state in place (under ``torch.no_grad()``) and returns None.

``params`` and ``grads`` are *groups*: {key: a tensor, or the list of
tensors that the JAX package stacks into one leaf}.  The JAX LM stacks each
slot of its layer period over the periods, and Adafactor's result depends
on that stacking: it factors every leaf of two or more dims (so a stacked
norm scale (n_periods, d) shares its column moment across layers) and
clips the update by the RMS of the whole leaf.  So a group's state has the
stacked leaf's shape, Adafactor works on ``torch.stack(group)``, and
AdamW and SGDM, which are elementwise, update each member through a view
of the stacked state.  ``repro_torch.convert.group(dict(model.
named_parameters()), model)`` gives a model's groups; a dict of plain
tensors is a set of groups of one.

All state is float32 whatever the parameter's dtype; the update is computed
in float32 and cast back to the parameter's dtype.  The step count and the
bias corrections are float32 tensors, as the JAX package computes them
(Python floats would drift at 1e-7).  Where the JAX package returns new
trees, the port writes the parameters and state in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Union

import torch

from repro_torch.models.params import ParamSpec

__all__ = ["Optimizer", "make_optimizer", "Groups"]

Group = Union[torch.Tensor, List[torch.Tensor]]
Groups = Mapping[str, Group]
State = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    lr: float
    init: Callable[[Groups], State]
    state_specs: Callable[[Any], Any]
    update: Callable[[Groups, State, Groups, int], None]


def _shape(group: Group) -> tuple:
    """The JAX leaf's shape: a list of members is stacked on a new axis 0."""
    if isinstance(group, torch.Tensor):
        return tuple(group.shape)
    return (len(group),) + tuple(group[0].shape)


def _device(group: Group) -> torch.device:
    return group.device if isinstance(group, torch.Tensor) else group[0].device


def _members(group: Group) -> List[torch.Tensor]:
    return [group] if isinstance(group, torch.Tensor) else list(group)


def _map_specs(fn, tree):
    """``fn`` on every spec of a tree of dicts and lists; a list of specs is
    a stacked group, one spec with a leading ``"layers"`` axis."""
    if isinstance(tree, ParamSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, list) and tree and all(isinstance(v, ParamSpec) for v in tree):
        s = tree[0]
        return fn(dataclasses.replace(s, shape=(len(tree),) + s.shape, axes=("layers",) + s.axes))
    if isinstance(tree, list):
        return [_map_specs(fn, v) for v in tree]
    raise TypeError(f"not a spec tree: {type(tree).__name__}")


def _zeros_spec(shape, axes) -> ParamSpec:
    return ParamSpec(tuple(shape), tuple(axes), torch.float32, "zeros")


def _step_t(step: int, device: torch.device) -> torch.Tensor:
    """t = step + 1 as a float32 scalar, as the JAX package computes it."""
    return torch.tensor(step, dtype=torch.float32, device=device) + 1.0


def _elementwise(groups: Groups, grads: Groups, state: State, fn) -> None:
    """``fn(g32, state views, p)`` -> the float32 update of p, member by
    member, each member's state a view of its row of the stacked state."""
    with torch.no_grad():
        for key, group in groups.items():
            stacked = not isinstance(group, torch.Tensor)
            for i, (g, p) in enumerate(zip(_members(grads[key]), _members(group))):
                views = {n: (s[i] if stacked else s) for n, s in state[key].items()}
                p.copy_(fn(g.float(), views, p).to(p.dtype))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _adamw(lr: float, b1=0.9, b2=0.95, eps=1e-8, wd=0.1) -> Optimizer:
    def init(params: Groups) -> State:
        return {k: {"_s_m": torch.zeros(_shape(g), dtype=torch.float32, device=_device(g)),
                    "_s_v": torch.zeros(_shape(g), dtype=torch.float32, device=_device(g))}
                for k, g in params.items()}

    def state_specs(specs):
        return _map_specs(lambda s: {"_s_m": _zeros_spec(s.shape, s.axes),
                                     "_s_v": _zeros_spec(s.shape, s.axes)}, specs)

    def update(grads: Groups, state: State, params: Groups, step: int) -> None:
        if not params:
            return
        t = _step_t(step, _device(next(iter(params.values()))))
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t

        def upd(g, st, p):
            m, v = st["_s_m"], st["_s_v"]
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            mhat = m / bc1
            vhat = v / bc2
            p32 = p.float()
            delta = mhat / (torch.sqrt(vhat) + eps) + wd * p32
            return p32 - lr * delta

        _elementwise(params, grads, state, upd)

    return Optimizer("adamw", lr, init, state_specs, update)


# ---------------------------------------------------------------------------
# Adafactor (simplified: factored v, no relative step warmup)
# ---------------------------------------------------------------------------

def _adafactor(lr: float, decay=0.99, eps=1e-30, clip=1.0) -> Optimizer:
    def _factored(shape) -> bool:
        return len(shape) >= 2

    def init(params: Groups) -> State:
        def st(g):
            shape, dev = _shape(g), _device(g)
            if _factored(shape):
                return {"_s_vr": torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
                        "_s_vc": torch.zeros(shape[:-2] + shape[-1:], dtype=torch.float32,
                                             device=dev)}
            return {"_s_v": torch.zeros(shape, dtype=torch.float32, device=dev)}
        return {k: st(g) for k, g in params.items()}

    def state_specs(specs):
        def st(s):
            if _factored(s.shape):
                return {"_s_vr": _zeros_spec(s.shape[:-1], s.axes[:-1]),
                        "_s_vc": _zeros_spec(s.shape[:-2] + s.shape[-1:],
                                             s.axes[:-2] + s.axes[-1:])}
            return {"_s_v": _zeros_spec(s.shape, s.axes)}
        return _map_specs(st, specs)

    def update(grads: Groups, state: State, params: Groups, step: int) -> None:
        with torch.no_grad():
            for key, group in params.items():
                members = _members(group)
                g_members = _members(grads[key])
                if isinstance(group, torch.Tensor):
                    g = g_members[0].float()
                else:
                    g = torch.stack([m.float() for m in g_members])
                st = state[key]
                g2 = g * g + eps
                if _factored(g.shape):
                    vr, vc = st["_s_vr"], st["_s_vc"]
                    vr.copy_(decay * vr + (1 - decay) * g2.mean(-1))
                    vc.copy_(decay * vc + (1 - decay) * g2.mean(-2))
                    denom = (vr[..., None] * vc[..., None, :]
                             / torch.clamp_min(vr.mean(-1)[..., None, None], eps))
                    upd = g * torch.rsqrt(denom + eps)
                else:
                    v = st["_s_v"]
                    v.copy_(decay * v + (1 - decay) * g2)
                    upd = g * torch.rsqrt(v + eps)
                # update clipping by RMS, over the whole (stacked) leaf
                rms = torch.sqrt(torch.mean(upd * upd) + 1e-30)
                upd = upd / torch.clamp_min(rms / clip, 1.0)
                if isinstance(group, torch.Tensor):
                    upd = upd[None]
                for p, u in zip(members, upd):
                    p.copy_((p.float() - lr * u).to(p.dtype))

    return Optimizer("adafactor", lr, init, state_specs, update)


# ---------------------------------------------------------------------------
# SGD + momentum
# ---------------------------------------------------------------------------

def _sgdm(lr: float, momentum=0.9) -> Optimizer:
    def init(params: Groups) -> State:
        return {k: {"_s_m": torch.zeros(_shape(g), dtype=torch.float32, device=_device(g))}
                for k, g in params.items()}

    def state_specs(specs):
        return _map_specs(lambda s: {"_s_m": _zeros_spec(s.shape, s.axes)}, specs)

    def update(grads: Groups, state: State, params: Groups, step: int) -> None:
        def upd(g, st, p):
            m = st["_s_m"]
            m.copy_(momentum * m + g)
            return p.float() - lr * m

        _elementwise(params, grads, state, upd)

    return Optimizer("sgdm", lr, init, state_specs, update)


def make_optimizer(name: str, lr: float = 1e-3) -> Optimizer:
    if name == "adamw":
        return _adamw(lr)
    if name == "adafactor":
        return _adafactor(lr)
    if name == "sgdm":
        return _sgdm(lr)
    raise ValueError(f"unknown optimizer {name!r}")
