"""Elastic scaling & failure handling for the coded runtime.

The paper's core elasticity argument (§4.4): because every worker holds a
*coded* partition, the scheduler can retarget work after failures without
moving data — robustness degrades gracefully from (n, k) toward k live
workers.  At pod scale the same logic governs DP-group membership:

* ``FailureDetector`` — response-time heartbeats with the §4.3 timeout
  rule (mean of first-k responders × (1 + slack), slack ≈ predictor MAPE);
* ``ElasticPlan`` — given the live set, rebuilds the S²C² allocation and
  the gradient-code decode weights; if live < k the plan degrades to
  "wait for stragglers" (the conventional-coded-computing fallback);
* ``remesh`` — builds a smaller production mesh from surviving hosts
  (chips of dead hosts removed); checkpoint restore handles re-sharding
  (see checkpoint.py — elastic by construction).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Set

import numpy as np

from repro_torch.core.s2c2 import Allocation, general_allocation

__all__ = ["FailureDetector", "ElasticPlan", "remesh_shape"]


@dataclasses.dataclass
class FailureDetector:
    """Timeout-based straggler/failure detection (§4.3)."""

    n: int
    k: int
    slack: float = 0.15
    dead_after: int = 3            # consecutive timeouts ⇒ declared dead

    def __post_init__(self):
        self.timeout_strikes = np.zeros(self.n, dtype=np.int64)

    def evaluate(self, response_times: np.ndarray) -> Dict[str, object]:
        """response_times: (n,) seconds, np.inf for no response."""
        response_times = np.asarray(response_times, dtype=np.float64)
        finite = np.isfinite(response_times)
        # The first-k mean must only average *actual* responders: with fewer
        # than k finite responses an inf would make the timeout inf and no
        # straggler would ever be flagged.  Clamp to the finite responders;
        # non-responders are always struck.
        n_base = min(self.k, int(finite.sum()))
        if n_base == 0:
            timeout = np.inf
            timed_out = ~finite          # nobody responded: strike everyone
        else:
            order = np.argsort(np.where(finite, response_times, np.inf))
            k_first = order[:n_base]
            base = float(np.mean(response_times[k_first]))
            timeout = base * (1.0 + self.slack)
            timed_out = (response_times > timeout) | ~finite
        self.timeout_strikes = np.where(timed_out,
                                        self.timeout_strikes + 1, 0)
        dead = self.timeout_strikes >= self.dead_after
        return {"timeout": timeout,
                "stragglers": set(np.nonzero(timed_out & ~dead)[0].tolist()),
                "dead": set(np.nonzero(dead)[0].tolist())}

    def reset_worker(self, worker: int) -> None:
        """Forget a worker's strikes (rejoin after a cleared verdict)."""
        self.timeout_strikes[worker] = 0


@dataclasses.dataclass
class ElasticPlan:
    """Re-plan allocation + decode weights for the current live set."""

    n: int
    k: int
    chunks: int = 60

    def plan(self, speeds: np.ndarray, dead: Set[int]) -> Allocation:
        live = [w for w in range(self.n) if w not in dead]
        if len(live) < self.k:
            raise RuntimeError(
                f"only {len(live)} live workers < k={self.k}: job must "
                f"restore from checkpoint on a smaller mesh (remesh_shape)")
        masked = np.asarray(speeds, dtype=np.float64).copy()
        masked[list(dead)] = 0.0
        return general_allocation(masked, self.k, self.chunks)


def remesh_shape(total_chips: int, model_parallel: int = 16
                 ) -> Optional[tuple]:
    """Largest (data, model) mesh that fits the surviving chip count.

    Keeps the model axis fixed (param layout unchanged ⇒ checkpoint
    restores without transposition) and shrinks data parallelism.
    """
    data = total_chips // model_parallel
    if data < 1:
        return None
    return (data, model_parallel)
