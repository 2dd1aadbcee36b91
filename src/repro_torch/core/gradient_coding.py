"""Gradient coding across data-parallel groups — S²C² beyond linear algebra.

The paper's exact MDS coding requires linearity in the coded operand, so it
cannot wrap a nonlinear model forward.  What *is* linear is the reduction
``g = Σ_p g_p`` over per-partition gradients — the observation behind
gradient coding (Tandon et al., cited as [36] by the paper).  We combine it
with S²C²'s scheduling:

* the global batch is over-decomposed into ``parts`` data partitions;
* DP group ``w`` is *assigned* a cyclic window of ``s + 1`` consecutive
  partitions (cyclic repetition code ⇒ tolerates any ``s`` stragglers);
* each group returns one coded gradient ``c_w = Σ_p B[w, p] · g_p``;
* the master recovers ``Σ_p g_p`` from ANY ``n − s`` groups by solving for
  decode coefficients ``a`` with ``aᵀ B_live = 1ᵀ`` (least squares; exact
  for the cyclic code by construction);
* **S²C² twist**: the *sizes* of the partitions are re-balanced every step
  from predicted group speeds with ``general_allocation`` — fast groups get
  more examples, slow groups fewer, with the coded coverage invariant
  (every example's gradient reaches ≥ n − s groups' windows) intact.

The coefficients, the decode weights and the re-balancing are numpy
float64, made by the same calls as the JAX package's, so ``B`` is equal to
its bit for bit; the one device step, :meth:`CyclicGradientCode.encode_local`,
is a ``torch.tensordot`` on the window's device.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

import numpy as np
import torch

__all__ = ["CyclicGradientCode", "decode_coefficients"]


def _cyclic_assignment(n: int, s: int) -> np.ndarray:
    """B support: group w covers partitions {w, w+1, .., w+s} (mod n)."""
    b = np.zeros((n, n), dtype=np.float64)
    for w in range(n):
        for j in range(s + 1):
            b[w, (w + j) % n] = 1.0
    return b


def _coefficient_matrix(n: int, s: int, seed: int = 0) -> np.ndarray:
    """Cyclic gradient-code coefficients via the null-space construction
    (Tandon et al., Algorithm 1 for B_cyc).

    Draw H ∈ R^{s×n} Gaussian and project its rows orthogonal to 1 so that
    H·1 = 0.  Row i of B is the (unique up to scale) vector supported on
    the cyclic window {i, …, i+s} lying in null(H).  Then every b_i and 1
    live in the (n−s)-dim null(H); any n−s of the b_i span it generically,
    so 1 ∈ rowspace(B_live) for every straggler pattern — exact decode.
    """
    if s == 0:
        return np.eye(n)
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((s, n))
    h -= h.mean(axis=1, keepdims=True)          # H·1 = 0
    b = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        supp = [(i + j) % n for j in range(s + 1)]
        hs = h[:, supp]                          # s × (s+1)
        # null vector of hs: smallest right singular vector
        _, _, vt = np.linalg.svd(hs)
        v = vt[-1]
        # normalize by the largest-magnitude entry: keeps coefficients in
        # [-1, 1], which keeps the decode weights well-conditioned
        peak = np.abs(v).max()
        if peak < 1e-9:
            raise ValueError("degenerate null vector; change seed")
        b[i, supp] = v / (peak * np.sign(v[np.argmax(np.abs(v))]))
    return b


def decode_coefficients(b: np.ndarray, live: Sequence[int]) -> np.ndarray:
    """Find a with aᵀ B[live] = 1ᵀ (the all-ones row)  → decoded g = Σ a_w c_w."""
    live = np.asarray(live)
    b_live = b[live]                                 # (m, parts)
    ones = np.ones(b.shape[1])
    a, res, rank, _ = np.linalg.lstsq(b_live.T, ones, rcond=None)
    if not np.allclose(b_live.T @ a, ones, atol=1e-6):
        raise ValueError(f"straggler pattern not decodable: live={live.tolist()}")
    return a


@dataclasses.dataclass(frozen=True)
class CyclicGradientCode:
    """Cyclic-repetition gradient code over n DP groups tolerating s stragglers."""

    n: int
    s: int
    seed: int = 0
    verify_patterns: bool = True

    def __post_init__(self):
        if not 0 <= self.s < self.n:
            raise ValueError(f"need 0 <= s < n, got s={self.s}, n={self.n}")
        b = _coefficient_matrix(self.n, self.s, self.seed)
        object.__setattr__(self, "B", b)
        if self.verify_patterns and self.n <= 16:
            for dead in itertools.combinations(range(self.n), self.s):
                live = [w for w in range(self.n) if w not in dead]
                decode_coefficients(b, live)   # raises if undecodable

    @property
    def parts(self) -> int:
        return self.n

    # -- device-side encode: each group combines its window of gradients ----
    def encode_local(self, grads_window: torch.Tensor, w: int) -> torch.Tensor:
        """grads_window: (s+1, ...) gradients of the partitions in group w's
        window (in cyclic order w, w+1, ...); returns the coded gradient."""
        c = torch.as_tensor(self.B[w, self.window(int(w))]).to(
            device=grads_window.device, dtype=grads_window.dtype)   # (s+1,)
        return torch.tensordot(c, grads_window, dims=([0], [0]))

    def window(self, w: int) -> list[int]:
        return [(w + j) % self.n for j in range(self.s + 1)]

    # -- host-side decode plan ----------------------------------------------
    def decode_weights(self, live: Sequence[int]) -> np.ndarray:
        """(n,) weights, zero for dead groups: g = Σ_w a_w · c_w."""
        a = decode_coefficients(self.B, live)
        out = np.zeros(self.n)
        out[np.asarray(live)] = a
        return out

    # -- S²C² partition re-balancing ----------------------------------------
    def balanced_part_sizes(self, speeds: np.ndarray, batch: int) -> np.ndarray:
        """Re-balance partition sizes ∝ the mean speed of the s+1 groups
        whose window covers each partition (fast coverage ⇒ more examples).
        Returns int sizes summing to ``batch``; every partition > 0."""
        cover_speed = np.zeros(self.n)
        for p in range(self.n):
            holders = [(p - j) % self.n for j in range(self.s + 1)]
            cover_speed[p] = np.mean(speeds[holders])
        share = cover_speed / cover_speed.sum()
        sizes = np.maximum(1, np.floor(share * batch).astype(np.int64))
        # largest-remainder fixup to sum exactly to batch
        while sizes.sum() > batch:
            sizes[np.argmax(sizes)] -= 1
        rema = share * batch - sizes
        while sizes.sum() < batch:
            i = int(np.argmax(rema))
            sizes[i] += 1
            rema[i] = -1
        return sizes
