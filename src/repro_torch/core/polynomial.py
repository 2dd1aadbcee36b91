"""Polynomial coded computing (§5) and S²C² on top of it.

Bilinear computation C = Aᵀ·D·B (the paper evaluates Hessians Aᵀ f(x) A)
distributed over n nodes.  A is split column-wise into ``a`` blocks, B into
``b`` blocks.  Node i (evaluation point x_i) stores

    Ã_i = Σ_j x_i^j        A_j          (degree step 1)
    B̃_i = Σ_j x_i^(a·j)    B_j          (degree step a)

and computes Ã_iᵀ · D · B̃_i, which is the evaluation at x_i of a matrix
polynomial of degree a·b − 1 whose coefficients include every block product
A_jᵀ D B_l.  Any m = a·b node results interpolate the polynomial and hence
recover all block products — the "any m of n" property.

S²C² applies row-range scheduling on top (Fig. 5): the output rows of each
node's product are over-decomposed into chunks; every chunk index must be
covered by ≥ m nodes; chunk ranges are assigned cyclically in proportion to
predicted speeds by the *same* Algorithm 1 (``general_allocation`` with
k := m).  Decoding interpolates per chunk from its covering nodes.

Numerical note: interpolation at integer points 0..n−1 (the paper's choice)
is catastrophically ill-conditioned beyond tiny m, so the default
evaluation points are Chebyshev nodes; ``points="integer"`` reproduces the
paper exactly for small m.  Decode solves the transposed Vandermonde system
in float64 on the host; the device path applies precomputed interpolation
weights as a matmul.

The port's products are plain ``torch.tensordot`` and ``torch.matmul`` on
the operands' device, as the JAX package computes them outside any Pallas
kernel; run them with TF32 off (``torch.backends.cuda.matmul.allow_tf32``,
False by default) so that a card computes in float32 as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.s2c2 import Allocation, general_allocation
from repro_torch.core.simulation import CostModel, IterationResult
from repro_torch.core.strategies import _execute_s2c2

__all__ = ["PolynomialCode", "PolyCodedStrategy", "PolyS2C2Strategy"]


@dataclasses.dataclass(frozen=True)
class PolynomialCode:
    """Polynomial code for Aᵀ·D·B with a×b partitioning on n nodes."""

    n: int
    a: int = 2
    b: int = 2
    points: str = "chebyshev"   # "chebyshev" | "integer"

    def __post_init__(self):
        m = self.a * self.b
        if self.n < m:
            raise ValueError(f"n={self.n} < a*b={m}: not decodable")
        if self.points == "integer":
            xs = np.arange(self.n, dtype=np.float64)
        elif self.points == "chebyshev":
            xs = np.cos((2 * np.arange(self.n) + 1) * np.pi / (2 * self.n))
        else:
            raise ValueError(f"unknown points {self.points!r}")
        object.__setattr__(self, "xs", xs)

    @property
    def m(self) -> int:
        """Responses needed per output row (= a·b)."""
        return self.a * self.b

    # -- encoding -----------------------------------------------------------
    def encode_a(self, a_mat: torch.Tensor) -> torch.Tensor:
        """A: (r, ca) split col-wise into `a` blocks -> (n, r, ca/a) coded."""
        powers = np.power(self.xs[:, None], np.arange(self.a)[None, :])
        return _encode(powers, a_mat, self.a)

    def encode_b(self, b_mat: torch.Tensor) -> torch.Tensor:
        """B: (r, cb) split col-wise into `b` blocks, degree step a."""
        degrees = self.a * np.arange(self.b)
        powers = np.power(self.xs[:, None], degrees[None, :])
        return _encode(powers, b_mat, self.b)

    # -- node computation ----------------------------------------------------
    @staticmethod
    def node_compute(a_coded: torch.Tensor, b_coded: torch.Tensor,
                     diag: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Node i computes Ã_iᵀ (diag·) B̃_i -> (ca/a, cb/b)."""
        lhs = a_coded if diag is None else a_coded * diag[:, None]
        return lhs.T @ b_coded

    # -- decoding ------------------------------------------------------------
    def interp_matrix(self, nodes: Sequence[int]) -> np.ndarray:
        """(m, m) map from m node results to the m polynomial coefficients.

        Row-major coefficient order: coefficient of x^(j + a·l) is block
        product A_jᵀ D B_l at index j + a·l (all degrees 0..m−1 distinct).
        """
        nodes = np.asarray(nodes)
        m = self.m
        if nodes.shape[0] != m:
            raise ValueError(f"need exactly m={m} nodes")
        v = np.power(self.xs[nodes][:, None], np.arange(m)[None, :])
        return np.linalg.inv(v)

    def decode(self, results: torch.Tensor, nodes: Sequence[int]) -> torch.Tensor:
        """results: (m, ra, rb) node products -> (a, b, ra, rb) block products."""
        w = torch.as_tensor(self.interp_matrix(nodes)).to(device=results.device,
                                                          dtype=results.dtype)
        flat = results.reshape(self.m, -1)
        coeffs = (w @ flat).reshape((self.m,) + tuple(results.shape[1:]))
        # coefficient index j + a*l -> (j, l)
        out = coeffs.reshape((self.b, self.a) + tuple(results.shape[1:]))  # l major
        return torch.swapaxes(out, 0, 1)                                    # (a, b, ...)

    def full_product(self, a_mat: torch.Tensor, b_mat: torch.Tensor,
                     diag: Optional[torch.Tensor] = None,
                     nodes: Optional[Sequence[int]] = None) -> torch.Tensor:
        """End-to-end helper: distribute, compute on `nodes`, decode, stitch."""
        nodes = list(range(self.m)) if nodes is None else list(nodes)
        ac, bc = self.encode_a(a_mat), self.encode_b(b_mat)
        results = torch.stack([self.node_compute(ac[i], bc[i], diag) for i in nodes])
        blocks = self.decode(results, nodes)         # (a, b, ca/a, cb/b)
        return torch.cat(
            [torch.cat([blocks[j, l] for l in range(self.b)], dim=1)
             for j in range(self.a)], dim=0)


def _encode(powers: np.ndarray, mat: torch.Tensor, parts: int) -> torch.Tensor:
    """Σ_j powers[:, j] · (column block j of ``mat``) -> (n, r, c/parts), on
    mat's device and in its dtype."""
    if mat.shape[1] % parts:
        raise ValueError(f"{mat.shape[1]} columns do not split into {parts} equal blocks")
    blocks = torch.stack(torch.chunk(mat, parts, dim=1), dim=0)
    coef = torch.as_tensor(powers).to(device=mat.device, dtype=mat.dtype)
    return torch.tensordot(coef, blocks, dims=([1], [0]))


# ---------------------------------------------------------------------------
# Latency strategies (Fig. 12): conventional polynomial vs S²C² on top
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PolyCodedStrategy:
    """Conventional polynomial coding: full partitions, fastest m used.

    ``fixed_fraction`` models the f(x)·Ã_i pre-computation that S²C² cannot
    squeeze (§7.2.4): that share of per-node work is always performed in
    full by the fastest m responders' critical path.
    """

    n: int
    m: int                      # = a·b responses needed
    total_rows: int             # output rows per node partition
    fixed_fraction: float = 0.25

    def plan(self, pred_speeds):
        return None

    def execute(self, plan, speeds: np.ndarray, cost: CostModel,
                rng: np.random.Generator) -> IterationResult:
        # full per-node work = bilinear rows + the fixed f(x)·Ã_i share
        rp = self.total_rows / (1.0 - self.fixed_fraction)
        t = np.array([cost.compute_time(rp, s) for s in speeds])
        order = np.argsort(t)
        t_done = t[order[self.m - 1]]
        useful = np.zeros(self.n)
        wasted = np.zeros(self.n)
        for rank, w in enumerate(order):
            if rank < self.m:
                useful[w] = rp
            else:
                wasted[w] = min(rp, speeds[w] * t_done / cost.row_cost)
        comm = cost.vector_bcast_time(self.n) + cost.collect_time(rp * self.m)
        post = cost.postprocess_time(rp * self.m)
        return IterationResult(makespan=float(t_done) + comm + post,
                               compute_time=float(t_done), comm_time=comm,
                               post_time=post, useful_rows=useful,
                               wasted_rows=wasted)


@dataclasses.dataclass
class PolyS2C2Strategy:
    """General S²C² scheduling over a polynomial code (Fig. 5, Fig. 12).

    The squeezable part (the bilinear row products) is allocated by
    Algorithm 1 with k := m; the fixed part (f(x)·Ã_i) is computed in full
    by every node that received any allocation.
    """

    n: int
    m: int
    total_rows: int
    chunks: int = 36
    fixed_fraction: float = 0.25
    timeout_slack: float = 0.15

    def __post_init__(self):
        self.rows_per_chunk = -(-self.total_rows // self.chunks)

    def plan(self, pred_speeds: Optional[np.ndarray]) -> Allocation:
        """Fixed-part-aware planning: a node that receives ANY allocation
        must compute the full f(x)·Ã_i prework, so very slow nodes can cost
        more (in fixed time) than their marginal compute contributes.  Try
        using only the j fastest nodes for j = m..n and pick the j with the
        smallest predicted makespan, then run Algorithm 1 on that subset."""
        speeds = np.asarray(pred_speeds if pred_speeds is not None
                            else np.ones(self.n), dtype=np.float64)
        order = np.argsort(-speeds)
        fixed_rows = self.total_rows * self.fixed_fraction / (1 - self.fixed_fraction)
        best_j, best_t = self.n, np.inf
        for j in range(self.m, self.n + 1):
            used = order[:j]
            u = np.maximum(speeds[used], 1e-9)
            # Alg-1 equalizes squeezable completion ≈ m·R/Σu; each used node
            # additionally pays its own fixed time.
            t = self.m * self.total_rows / u.sum() + fixed_rows / u.min()
            if t < best_t:
                best_t, best_j = t, j
        masked = np.zeros(self.n)
        masked[order[:best_j]] = speeds[order[:best_j]]
        return general_allocation(masked, self.m, self.chunks)

    def execute(self, alloc: Allocation, speeds: np.ndarray, cost: CostModel,
                rng: np.random.Generator) -> IterationResult:
        res = _execute_s2c2(alloc, self.rows_per_chunk, speeds, cost,
                            self.timeout_slack)
        # add the un-squeezable fixed work (f(x)·Ã_i): every *responding*
        # node pays it fully.  Nodes cancelled by the timeout contribute
        # nothing — their chunks were reassigned to finishers who already
        # completed their own fixed part.
        fixed_rows = self.total_rows * self.fixed_fraction / (1 - self.fixed_fraction)
        responded = (alloc.count > 0) & (res.useful_rows > 0)
        if not responded.any():
            responded = alloc.count > 0
        t_fixed = float(np.max(np.where(
            responded, fixed_rows * cost.row_cost / np.maximum(speeds, 1e-9),
            0.0)))
        return IterationResult(
            makespan=res.makespan + t_fixed,
            compute_time=res.compute_time + t_fixed,
            comm_time=res.comm_time, post_time=res.post_time,
            useful_rows=res.useful_rows, wasted_rows=res.wasted_rows,
            reassigned=res.reassigned, mispredicted=res.mispredicted)
