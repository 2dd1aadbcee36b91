"""Fault-tolerant training loop with S²C²-coded data parallelism, on PyTorch.

The port of the JAX package's ``runtime/train_loop.py``:

* **checkpoint/restart** — periodic checkpoints (parameters, optimizer
  state, the data pipeline's cursor); on (re)start the loop resumes from
  the latest checkpoint;
* **S²C² gradient coding over DP groups** — the global batch is split into
  ``n_groups`` partitions whose sizes re-balance every step from the
  groups' predicted speeds (``CyclicGradientCode.balanced_part_sizes``);
  each group returns one coded gradient over its cyclic window; the decode
  tolerates up to ``s`` missing groups;
* **timeout (§4.3)** — groups not reporting within ``(1 + slack)·mean(first
  n − s response times)`` are stragglers for this step; their contribution
  is recovered from the code.

As in the JAX package, the DP groups are simulated on one device: each
group's gradients are computed in turn and combined exactly as the coded
runtime would, and a group's response time is its examples over its true
speed.  The speed predictor has no parameters, so it forecasts each
group's last observed speed, as the JAX package's does: the training path
reaches none of the port's kernels.  Microbatches are numpy slices of the
batch, each moved to the device once.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint.checkpoint import (cleanup_old, latest_step, restore_checkpoint,
                                               save_checkpoint)
from repro_torch.convert import group
from repro_torch.core.gradient_coding import CyclicGradientCode
from repro_torch.core.predictor import SpeedPredictor
from repro_torch.data.pipeline import TokenPipeline

__all__ = ["TrainLoopConfig", "train", "CodedDPStep"]


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_keep: int = 3
    # S²C² DP coding
    n_groups: int = 8
    stragglers_tolerated: int = 2
    timeout_slack: float = 0.15
    log_every: int = 10


def _to_device(mb: Dict[str, np.ndarray], dev: torch.device) -> Dict[str, torch.Tensor]:
    """A microbatch on ``dev``: token ids as int64, the rest as they are."""
    out = {}
    for k, v in mb.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = (t.long() if k in ("tokens", "labels") else t).to(dev)
    return out


class CodedDPStep:
    """One S²C²-coded data-parallel gradient step of ``model`` over n
    simulated groups, on the model's device."""

    def __init__(self, model, n_groups: int, s: int, timeout_slack: float = 0.15,
                 seed: int = 0):
        self.model = model
        self.device = model.device
        self.code = CyclicGradientCode(n=n_groups, s=s, seed=seed)
        self.n = n_groups
        self.s = s
        self.timeout_slack = timeout_slack
        self.names = [name for name, _ in model.named_parameters()]
        self.params = [p for _, p in model.named_parameters()]
        self.predictor = SpeedPredictor(n_groups, device=self.device)

    def partition_batch(self, batch: Dict[str, np.ndarray],
                        speeds: np.ndarray) -> List[Dict[str, np.ndarray]]:
        """Split the global batch into n unequal partitions ∝ coverage speed."""
        bsz = next(iter(batch.values())).shape[0]
        sizes = self.code.balanced_part_sizes(speeds, bsz)
        parts = []
        off = 0
        for sz in sizes:
            parts.append({k: v[off:off + sz] for k, v in batch.items()})
            off += sz
        return parts

    def step(self, batch: Dict[str, np.ndarray], group_speeds: np.ndarray,
             dead_groups: Optional[set] = None):
        """Returns (the decoded gradient {parameter name: float32 tensor},
        the mean loss, an info dict).

        group_speeds: true speeds this step (the simulator's ground truth);
        the predictor only sees past speeds.
        """
        dead_groups = dead_groups or set()
        pred = self.predictor.predict()
        parts = self.partition_batch(batch, pred)
        on_device: Dict[int, Dict[str, torch.Tensor]] = {}

        # each group computes gradients for its cyclic window of partitions
        # and returns ONE coded combination (the gradient-coding contract)
        coded: Dict[int, Optional[List[torch.Tensor]]] = {}
        losses = []
        times = np.zeros(self.n)
        for w in range(self.n):
            if w in dead_groups:
                continue
            g_acc = None
            t = 0.0
            for p_idx in self.code.window(w):
                mb = parts[p_idx]
                size = next(iter(mb.values())).shape[0]
                if size == 0:
                    continue
                if p_idx not in on_device:
                    on_device[p_idx] = _to_device(mb, self.device)
                loss = self.model.loss_fn(on_device[p_idx])
                grads = torch.autograd.grad(loss, self.params)
                losses.append(loss.item())
                coef = float(self.code.B[w, p_idx])
                if g_acc is None:
                    g_acc = [g.float() * coef for g in grads]
                else:           # in place: one leaf's product at a time
                    for a, g in zip(g_acc, grads):
                        a.add_(g.float() * coef)
                del grads
                t += size
            times[w] = t / max(group_speeds[w], 1e-9)
            coded[w] = g_acc

        # timeout rule (§4.3): the first n - s responders set the clock
        live_sorted = sorted(coded, key=lambda w: times[w])
        k_first = live_sorted[: self.n - self.s]
        timeout = np.mean([times[w] for w in k_first]) * (1 + self.timeout_slack)
        responders = [w for w in coded if times[w] <= timeout]
        if len(responders) < self.n - self.s:
            responders = live_sorted[: self.n - self.s]
        straggled = [w for w in coded if w not in responders]

        weights = self.code.decode_weights(sorted(responders))
        grad = None
        for w in sorted(responders):      # decoded in place into the coded trees
            if coded[w] is None:
                continue
            contrib = [g.mul_(float(weights[w])) for g in coded.pop(w)]
            if grad is None:
                grad = contrib
            else:
                for a, c in zip(grad, contrib):
                    a.add_(c)
            del contrib
        coded.clear()
        self.predictor.observe(group_speeds)
        info = {"straggled": straggled, "responders": len(responders),
                "makespan": float(max(times[w] for w in responders))}
        return dict(zip(self.names, grad)), float(np.mean(losses)), info


def train(model, opt, pipeline: TokenPipeline, cfg: TrainLoopConfig,
          speed_traces: Optional[np.ndarray] = None,
          fail_at: Optional[Dict[int, int]] = None) -> Dict:
    """Run the fault-tolerant coded training loop on ``model``, in place.

    fail_at: {step: group_id} — kill a DP group at a step (it stays dead
    for 5 steps, exercising timeout + decode).  Returns summary metrics.
    """
    resolve_device(model.device)
    groups = group(dict(model.named_parameters()), model)
    opt_state = opt.init(groups)
    start = 0
    if latest_step(cfg.ckpt_dir) is not None:
        start, _, _, extras = restore_checkpoint(cfg.ckpt_dir, model, opt_state)
        pipeline.restore(extras["pipeline"])
        start += 1

    coded = CodedDPStep(model, cfg.n_groups, cfg.stragglers_tolerated, cfg.timeout_slack)

    losses, makespans = [], []
    dead: Dict[int, int] = {}
    fail_at = fail_at or {}
    for step in range(start, cfg.total_steps):
        if step in fail_at:
            dead[fail_at[step]] = 5      # dead for 5 steps
        dead = {g: ttl - 1 for g, ttl in dead.items() if ttl > 0}

        batch = pipeline.next_batch()
        if speed_traces is not None:
            speeds = speed_traces[step % speed_traces.shape[0]]
        else:
            speeds = np.ones(cfg.n_groups)
        grad, loss, info = coded.step(batch, speeds, dead_groups=set(dead))
        for g in grad.values():
            g.div_(cfg.n_groups)
        opt.update(group(grad, model), opt_state, groups, step)
        del grad
        losses.append(loss)
        makespans.append(info["makespan"])
        if step % cfg.log_every == 0:
            print(f"[train] step={step} loss={loss:.4f} "
                  f"straggled={info['straggled']} dead={sorted(dead)}", flush=True)
        if cfg.ckpt_every and step and step % cfg.ckpt_every == 0:
            save_checkpoint(cfg.ckpt_dir, step, model, opt_state,
                            extras={"pipeline": pipeline.state()})
            cleanup_old(cfg.ckpt_dir, cfg.ckpt_keep)

    save_checkpoint(cfg.ckpt_dir, cfg.total_steps - 1, model, opt_state,
                    extras={"pipeline": pipeline.state()})
    return {"losses": losses, "makespans": makespans,
            "final_loss": float(np.mean(losses[-5:]))}
