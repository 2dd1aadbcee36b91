"""Serving driver: batched requests against a selectable architecture.

The port of the JAX package's ``launch/serve.py``, with its flags and one
more, ``--device`` (the card by default).  On one H100, at full width and
depth in bfloat16:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mistral-nemo-12b \\
        --coded-head

and on the CPU, on the reduced config:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mistral-nemo-12b \\
        --reduced --device cpu --coded-head

The weights are random, drawn from ``--seed``.  Every decoder arch is
served (the dense, vlm, MoE, SSM and hybrid families); the
encoder-decoder (seamless-m4t-large-v2) is refused with ``SystemExit``, as
the JAX package's entry point refuses it: its model
(``repro_torch.models.encdec.EncDecLM``) is driven through its own
``prefill`` and ``decode_step``.  ``--coded-head`` first
validates the S²C²-coded lm_head (a float32 copy of the head, (n, k) =
(6, 4), 8 chunks) against the dense product under two stragglers.

``main(argv)`` is ``run(args, build(args))`` with ``args =
parse_args(argv)``: a caller that measures the model further builds it
once with :func:`build` and serves with :func:`run`.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import build_model
from repro_torch.models.params import param_count, tree_bytes
from repro_torch.runtime.serve_loop import CodedLMHead, Request, ServeConfig, serve


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mistral-nemo-12b",
                    choices=list(ARCH_IDS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--coded-head", action="store_true",
                    help="validate the S²C²-coded lm_head against dense")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def build(args: argparse.Namespace):
    """The model ``args`` name, its weights drawn from ``--seed`` on
    ``--device``; ``SystemExit`` for the encoder-decoder."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.is_encdec:
        raise SystemExit("enc-dec serving demo: use examples/ or dryrun "
                         "(decode cells) — this driver targets decoder LMs")
    dev = resolve_device(args.device)
    return build_model(cfg, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(args.seed))


def run(args: argparse.Namespace, model) -> int:
    """Validate the coded head if ``--coded-head``, then serve ``--requests``
    requests with ``model`` (from :func:`build`) on its device."""
    cfg, dev = model.cfg, model.device
    specs = model.specs()
    print(f"[serve] arch={cfg.name} params={param_count(specs)/1e6:.1f}M "
          f"({tree_bytes(specs)/1e9:.2f} GB) on {dev}")

    if args.coded_head and not cfg.tie_embeddings:
        head = model.embed["head"].detach().float()
        ch = CodedLMHead(head, n=6, k=4, chunks=8, device=dev)
        x = torch.as_tensor(np.random.default_rng(1).standard_normal((2, cfg.d_model)),
                            dtype=torch.float32, device=dev)
        speeds = np.array([1, 1, 0.2, 1, 1, 0.5])
        want = x @ head
        err = float((ch.logits(x, speeds) - want).abs().max() / want.abs().max())
        print(f"[serve] coded lm_head rel_err={err:.2e} under stragglers "
              f"{speeds.tolist()}")
        del head, ch, want

    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(1, cfg.vocab_size,
                                        size=args.prompt_len).astype(np.int32),
                    max_new=args.max_new)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    out = serve(model, reqs, ServeConfig(max_batch=args.max_batch), device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    tokens = sum(len(v) for v in out.values())
    print(f"[serve] {len(reqs)} requests, {tokens} tokens in {dt:.1f}s "
          f"({tokens / dt:.1f} tok/s)")
    for rid in sorted(out)[:3]:
        print(f"[serve] request {rid}: {out[rid]}")
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    return run(args, build(args))


if __name__ == "__main__":
    raise SystemExit(main())
