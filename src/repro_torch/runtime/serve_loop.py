"""Batched serving loop with an S²C²-coded lm_head, for PyTorch.

The port of the JAX package's ``runtime/serve_loop.py``.  Serving is where
the paper's workload (repeated coded matvec) appears inside an LM system:
the final projection ``x @ W_head`` (d_model × vocab, the largest single
matmul of a decode step) can be computed under (n, k)-MDS coding with
per-call S²C² row assignment, so that a slow worker computes fewer vocab
rows and the decode recovers them.

:class:`CodedLMHead` holds the n coded partitions of the head on one card
(the leading dimension of one tensor, as ``CodedMatvec`` does) and computes
only the chunks Algorithm 1 assigns: the JAX package computes all n
partial products and masks the unassigned ones, the port never reads them.
Encoding is one ``mds_encode`` launch; each ``logits`` call is one
``coded_matvec`` launch per group of at most 16 columns of x and one
``mds_decode`` launch.

:func:`serve` keeps the JAX package's loop: requests in rid order, batches
of ``max_batch``, prompts left-padded with 0 and not masked, the prompt fed
through one decode step per position, greedy argmax (the first index wins
a tie).  The JAX package's ``serve`` also takes ``coded_head`` and
``worker_speeds`` and uses neither; the port leaves them out, so that no
caller asks for a coded head and silently gets the dense one.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.coded_matmul import CodedMatvec
from repro_torch.core.coding import MDSCode
from repro_torch.core.s2c2 import general_allocation

__all__ = ["ServeConfig", "Request", "serve", "CodedLMHead"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (prompt_len,) int32
    max_new: int = 16
    generated: Optional[List[int]] = None


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    max_seq: int = 256


class CodedLMHead:
    """(n, k)-MDS coded lm_head with S²C² row scheduling, on one device.

    The head matrix (d, V) is row-partitioned along VOCAB into k blocks,
    V padded with zero columns to a multiple of k·chunks, and encoded once
    into n coded partitions (worker w holds Σ_i G[w,i]·W_iᵀ, of shape
    (V_pad/k, d)), in the head's dtype, on ``device`` (the card by
    default).  Each call computes the assigned chunk ranges of each
    partition; any k per chunk decode the true logits.
    """

    def __init__(self, head: torch.Tensor, n: int, k: int, chunks: int = 16,
                 device: str | torch.device = "cuda"):
        self.n, self.k, self.chunks = n, k, chunks
        self.code = MDSCode(n=n, k=k)
        self.cm = CodedMatvec(self.code, chunks, device=device)
        d, v = head.shape
        self.v = v
        self.v_padded = v + (-v) % (k * chunks)
        self.coded = self.cm.shard(head.T)              # (n, V_pad/k, d)

    def logits(self, x: torch.Tensor, speeds: np.ndarray) -> torch.Tensor:
        """x: (B, d) -> (B, V) (a transposed view) via the assigned chunks'
        partial products and their decode, in the head's dtype."""
        alloc = general_allocation(np.asarray(speeds, dtype=np.float64), self.k, self.chunks)
        xt = x.to(device=self.coded.device, dtype=self.coded.dtype).T.contiguous()   # (d, B)
        y = self.cm.apply(self.coded, xt, *self.cm.plan_tables(alloc))          # (V_pad, B)
        return y[: self.v].T


def serve(model, requests: List[Request], cfg: ServeConfig,
          device: str | torch.device = "cuda") -> Dict[int, List[int]]:
    """Greedy continuous-batching serving of a request list on ``device``
    (the card by default), where ``model`` must lie.  Returns each
    request's generated token ids by rid."""
    dev = resolve_device(device)
    if model.device.type != dev.type or dev.index not in (None, model.device.index):
        raise ValueError(f"the model is on {model.device}, serving is on {dev}")
    pending = sorted(requests, key=lambda r: r.rid)
    results: Dict[int, List[int]] = {}

    while pending:
        batch = pending[: cfg.max_batch]
        pending = pending[cfg.max_batch:]
        bsz = len(batch)
        # left-pad prompts to common length
        plen = max(r.prompt.shape[0] for r in batch)
        toks = np.zeros((bsz, plen), np.int64)
        for i, r in enumerate(batch):
            toks[i, plen - r.prompt.shape[0]:] = r.prompt
        toks = torch.as_tensor(toks, device=dev)
        max_new = max(r.max_new for r in batch)
        caches = model.init_cache(bsz, plen + max_new)
        # prefill via decode steps (uniform across families)
        logits = None
        for t in range(plen):
            logits, caches = model.decode_step(toks[:, t:t + 1], caches, t)
        outs: List[List[int]] = [[] for _ in range(bsz)]
        cur = torch.argmax(logits, -1)[:, None]
        for step in range(max_new):
            for i, tok in enumerate(cur[:, 0].tolist()):
                outs[i].append(tok)
            logits, caches = model.decode_step(cur, caches, plen + step)
            cur = torch.argmax(logits, -1)[:, None]
        for i, r in enumerate(batch):
            results[r.rid] = outs[i][: r.max_new]
    return results
