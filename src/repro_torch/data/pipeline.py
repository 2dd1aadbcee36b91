"""Data pipeline: deterministic synthetic corpora with shardable batches.

A copy of the JAX package's, which is numpy only: the same seeds give the
same arrays, bit for bit.  An index-based pipeline (no filesystem
dependency) whose *cursor* is part of the checkpoint, so a restarted
job resumes mid-epoch without replaying or skipping data — the
fault-tolerance contract the runtime relies on.  Batches are yielded
host-local, as numpy arrays; the caller moves them to its device.

Also provides the paper's workloads: a gisette-like dense matrix for
LR/SVM gradient descent and synthetic power-law graphs for PageRank /
graph filtering.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np

__all__ = ["TokenPipeline", "make_lr_dataset", "make_graph",
           "laplacian_matrix"]


@dataclasses.dataclass
class TokenPipeline:
    """Deterministic synthetic token stream with a checkpointable cursor.

    Documents are generated per-index from a counter-based RNG, so batch i
    is reproducible from the cursor alone — restart-safe by construction.
    """

    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    cursor: int = 0                  # global example index (checkpointed)
    image_tokens: int = 0            # vlm stub
    image_dim: int = 0
    frames: int = 0                  # encdec stub
    frame_dim: int = 0

    def _example(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 32) ^ idx)
        # zipf-ish marginal over the vocab with local repetition structure
        base = rng.zipf(1.3, size=self.seq_len).astype(np.int64)
        tokens = (base + rng.integers(0, 97)) % self.vocab_size
        out = {"tokens": tokens.astype(np.int32)}
        if self.image_tokens:
            out["image_embeds"] = rng.standard_normal(
                (self.image_tokens, self.image_dim)).astype(np.float32)
        if self.frames:
            out["frames"] = rng.standard_normal(
                (self.frames, self.frame_dim)).astype(np.float32)
        return out

    def next_batch(self) -> Dict[str, np.ndarray]:
        exs = [self._example(self.cursor + i) for i in range(self.batch)]
        self.cursor += self.batch
        batch = {k: np.stack([e[k] for e in exs]) for k in exs[0]}
        batch["labels"] = batch["tokens"]
        return batch

    def state(self) -> Dict:
        return {"cursor": self.cursor, "seed": self.seed}

    def restore(self, state: Dict) -> None:
        self.cursor = int(state["cursor"])
        self.seed = int(state["seed"])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()


# ---------------------------------------------------------------------------
# Paper workloads
# ---------------------------------------------------------------------------

def make_lr_dataset(rows: int = 20000, cols: int = 500, seed: int = 0,
                    separable_noise: float = 0.5
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Gisette-like dense binary classification data (A, y, w_true).

    The paper duplicates the UCI gisette dataset (5000 features) to scale
    it; we synthesize an equivalent dense matrix with a planted separator
    so convergence is measurable.
    """
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((rows, cols))
    w_true = rng.standard_normal(cols) / np.sqrt(cols)
    logits = a @ w_true + separable_noise * rng.standard_normal(rows)
    y = (logits > 0).astype(np.float64) * 2 - 1
    return a, y, w_true


def make_graph(n: int = 4096, avg_degree: int = 16, seed: int = 0
               ) -> np.ndarray:
    """Random power-law-ish adjacency (dense array for matvec workloads)."""
    rng = np.random.default_rng(seed)
    # preferential attachment flavour: connection prob ∝ rank^-0.8
    ranks = np.arange(1, n + 1, dtype=np.float64) ** -0.8
    p = ranks / ranks.sum()
    adj = np.zeros((n, n), dtype=np.float64)
    m = n * avg_degree
    src = rng.integers(0, n, size=m)
    dst = rng.choice(n, size=m, p=p)
    adj[src, dst] = 1.0
    np.fill_diagonal(adj, 0.0)
    return adj


def laplacian_matrix(adj: np.ndarray) -> np.ndarray:
    """Combinatorial Laplacian L = D − A (graph filtering operator)."""
    deg = adj.sum(axis=1)
    return np.diag(deg) - adj
