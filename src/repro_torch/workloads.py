"""The paper's applications (§6.3) on the coded matvec: logistic regression
and the SVM by gradient descent, PageRank by power iteration and n-hop
graph filtering.

Every product ``A·x`` of a loop runs through a :class:`CodedMatvec` under
a fresh S²C² allocation, planned from ``speeds(it)``: the speeds to plan
iteration ``it`` with (a fixed vector, a trace's row, or a predictor's
forecast).  The rest of an iteration runs in the operands' dtype on their
device; gradient descent's ``Aᵀ·g`` is uncoded, as in the paper.  Where
``on_iter(it, x, y)`` is given, it sees each iteration's input ``x`` and
its decoded product ``y`` once the iteration's update is enqueued.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.coded_matmul import CodedMatvec
from repro_torch.core.s2c2 import general_allocation

__all__ = ["coded_product", "gd_gradient", "coded_gradient_descent", "pagerank",
           "graph_filter"]

Speeds = Callable[[int], np.ndarray]
OnIter = Optional[Callable[[int, torch.Tensor, torch.Tensor], None]]


def coded_product(cm: CodedMatvec, coded: torch.Tensor, x: torch.Tensor,
                  speeds: np.ndarray) -> torch.Tensor:
    """``A @ x`` from the coded partitions under Algorithm 1's allocation
    for ``speeds``; y in ``coded``'s dtype, padding rows at its end."""
    alloc = general_allocation(speeds, cm.code.k, cm.chunks)
    return cm.apply(coded, x.to(coded.dtype), *cm.plan_tables(alloc))


def gd_gradient(loss: str, a: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                ax: torch.Tensor) -> torch.Tensor:
    """The gradient of the logistic loss or of the hinge loss with an L2
    term of 1e-3, summed over the rows, from ``ax = A @ w``."""
    margin = y * ax
    if loss == "logistic":
        return a.T @ (-y / (1 + torch.exp(margin)))
    if loss == "hinge":
        return a.T @ (-y * (margin < 1)) + 1e-3 * w
    raise ValueError(f"loss must be 'logistic' or 'hinge', not {loss!r}")


def coded_gradient_descent(cm: CodedMatvec, coded: torch.Tensor, a: torch.Tensor,
                           y: torch.Tensor, loss: str, iters: int, speeds: Speeds,
                           lr: float = 0.5, on_iter: OnIter = None) -> torch.Tensor:
    """``iters`` steps of gradient descent from w = 0 with step ``lr`` over
    the number of rows; A·w coded (``coded = cm.shard(a)``), Aᵀ·g from
    ``a``.  Returns w, in ``a``'s dtype."""
    rows = a.shape[0]
    w = torch.zeros(a.shape[1], dtype=a.dtype, device=a.device)
    for it in range(iters):
        ax = coded_product(cm, coded, w, speeds(it))[:rows].to(a.dtype)
        w_next = w - (lr / rows) * gd_gradient(loss, a, y, w, ax)
        if on_iter is not None:
            on_iter(it, w, ax)
        w = w_next
    return w


def pagerank(cm: CodedMatvec, coded: torch.Tensor, n: int, iters: int, speeds: Speeds,
             damping: float = 0.85, on_iter: OnIter = None) -> torch.Tensor:
    """Power iteration ``r ← (1 - d)/n + d·M r`` from the uniform vector,
    ``coded = cm.shard(M)`` for a column-stochastic (n, n) M."""
    r = torch.full((n,), 1.0 / n, dtype=coded.dtype, device=coded.device)
    for it in range(iters):
        mr = coded_product(cm, coded, r, speeds(it))[:n]
        r_next = (1 - damping) / n + damping * mr
        if on_iter is not None:
            on_iter(it, r, mr)
        r = r_next
    return r


def graph_filter(cm: CodedMatvec, coded: torch.Tensor, x: torch.Tensor, hops: int,
                 speeds: Speeds, on_iter: OnIter = None) -> torch.Tensor:
    """``hops`` applications of the (n, n) operator, ``coded = cm.shard(L)``
    (the paper's n-hop filter on a graph's Laplacian), to x."""
    n = x.shape[0]
    x = x.to(coded.dtype)
    for it in range(hops):
        lx = coded_product(cm, coded, x, speeds(it))[:n]
        if on_iter is not None:
            on_iter(it, x, lx)
        x = lx
    return x
