"""End-to-end training entry point.

The port of the JAX package's ``launch/train.py``, with its flags and one
more, ``--device`` (the card by default; no fallback).  On one card, at
full width and depth in bfloat16:

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
        --steps 20 --batch 16 --seq 48 --coded-dp --fail-group 3

and on the CPU, on the reduced config:

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \\
        --steps 50 --batch 16 --seq 64 --reduced --coded-dp --device cpu

The weights are random, drawn from ``--seed``; the data is the synthetic
``TokenPipeline`` (frame embeddings for the encoder-decoder, image embeds
for the vlm) and the groups' speeds come from ``sample_traces``.  A
checkpoint under ``--ckpt-dir`` is resumed from.

``main(argv)`` is ``run(args, build(args))`` with ``args =
parse_args(argv)``: a caller that builds the model itself (at a cut depth,
say) trains it with :func:`run`, which reads the architecture from the
model's config and ``--arch``/``--reduced`` not at all.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.traces import TraceConfig, sample_traces
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import build_model
from repro_torch.models.params import param_count
from repro_torch.optim.optimizer import make_optimizer
from repro_torch.runtime.train_loop import TrainLoopConfig, train


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m", choices=list(ARCH_IDS))
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="train the same-family tiny config (CPU-friendly)")
    ap.add_argument("--coded-dp", action="store_true",
                    help="S²C² gradient coding across simulated DP groups")
    ap.add_argument("--groups", type=int, default=8)
    ap.add_argument("--tolerate", type=int, default=2)
    ap.add_argument("--fail-group", type=int, default=-1,
                    help="kill this group at step 10 (fault-tolerance demo)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def build(args: argparse.Namespace):
    """The model ``args`` name, its weights drawn from ``--seed`` on
    ``--device``."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    return build_model(cfg, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(args.seed))


def make_pipeline(cfg, args: argparse.Namespace) -> TokenPipeline:
    """The synthetic batches ``run`` trains ``cfg`` on: ``--batch`` x
    ``--seq`` tokens from ``--seed``, with image embeddings for a vlm and
    ``--seq // 2`` frames for the encoder-decoder."""
    return TokenPipeline(
        vocab_size=cfg.vocab_size, batch=args.batch, seq_len=args.seq,
        seed=args.seed,
        image_tokens=cfg.frontend_tokens if cfg.frontend == "vit_stub" else 0,
        image_dim=cfg.frontend_dim if cfg.frontend == "vit_stub" else 0,
        frames=args.seq // 2 if cfg.is_encdec else 0,
        frame_dim=cfg.frontend_dim if cfg.is_encdec else 0)


def run(args: argparse.Namespace, model) -> int:
    """Train ``model`` (from :func:`build`, or any model of the port on the
    device ``--device`` names) in place for ``--steps`` steps, with the
    optimizer its config names."""
    cfg, dev = model.cfg, resolve_device(args.device)
    if model.device.type != dev.type:
        raise ValueError(f"the model lies on {model.device}, not on --device {args.device}")
    print(f"[train] arch={cfg.name} params={param_count(model.specs())/1e6:.1f}M on {dev}",
          flush=True)
    opt = make_optimizer(cfg.optimizer, lr=args.lr)
    pipeline = make_pipeline(cfg, args)

    loop_cfg = TrainLoopConfig(
        total_steps=args.steps, ckpt_dir=args.ckpt_dir,
        n_groups=args.groups if args.coded_dp else 1,
        stragglers_tolerated=args.tolerate if args.coded_dp else 0,
        ckpt_every=max(args.steps // 4, 10))

    traces = sample_traces(TraceConfig(n_nodes=loop_cfg.n_groups,
                                       n_iters=max(args.steps, 32)),
                           seed=args.seed)
    fail_at = {10: args.fail_group} if args.fail_group >= 0 else None

    t0 = time.time()
    metrics = train(model, opt, pipeline, loop_cfg, speed_traces=traces, fail_at=fail_at)
    dt = time.time() - t0
    print(f"[train] done in {dt:.1f}s; final_loss={metrics['final_loss']:.4f} "
          f"first_loss={metrics['losses'][0]:.4f}")
    improved = metrics["final_loss"] < metrics["losses"][0]
    print(f"[train] loss_improved={improved}", flush=True)
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    return run(args, build(args))


if __name__ == "__main__":
    raise SystemExit(main())
