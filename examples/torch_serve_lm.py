"""Serve a small LM with batched requests + the S²C²-coded lm_head, on the
PyTorch/CUDA port.

The port of ``serve_lm.py``: the d_model → vocab projection (the biggest
matvec at decode) runs under a (6,4)-MDS code with per-batch S²C² row
scheduling, so a throttled model-parallel worker no longer gates every
token.  Checks the coded logits against the dense head under two speed
vectors, then serves a batch of requests.  On a card, the head's encode,
compute and decode are the port's three CUDA kernels.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.runtime.serve_loop import CodedLMHead, Request, ServeConfig, serve


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args().device)
    cfg = get_config("mistral-nemo-12b").reduced()
    model = build_model(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))

    # --- coded lm_head check ------------------------------------------------
    head = model.embed["head"].detach().float()          # (d, vocab)
    coded_head = CodedLMHead(head, n=6, k=4, chunks=8, device=dev)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal((4, cfg.d_model)),
                        dtype=torch.float32, device=dev)
    for speeds in (np.ones(6), np.array([1, 1, 0.2, 1, 1, 0.3])):
        got = coded_head.logits(x, speeds)
        want = x @ head
        err = float((got - want).abs().max() / want.abs().max())
        print(f"coded lm_head rel_err={err:.2e} @ speeds={speeds.tolist()}")
        assert err < 1e-3

    # --- batched serving ----------------------------------------------------
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab_size, size=6).astype(np.int32),
                    max_new=8)
            for i in range(6)]
    out = serve(model, reqs, ServeConfig(max_batch=3), device=dev)
    for rid in sorted(out):
        print(f"request {rid}: generated {out[rid]}")
    assert all(len(v) == 8 for v in out.values())
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
