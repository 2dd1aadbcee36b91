"""Generative model of per-node execution speeds.

Fitted to the paper's measurements (§3.2, Fig. 2) on 100 DigitalOcean
shared droplets:

* speeds normalized to each node's max; slow drift — "the speed observed at
  any time slot stays within 10 % for about 10 samples within the
  neighborhood" — modeled as an OU (mean-reverting) process with a small
  step size;
* occasional regime shifts (a shared VM gaining/losing a noisy neighbor) —
  Markov switches between a FAST regime (speed ≈ base) and a STRAGGLER
  regime (speed ≈ base / slowdown, paper: 5×);
* non-straggler heterogeneity up to ±20 % (§7.1.1);
* small iid measurement noise.

Also provides deterministic *controlled-cluster* scenarios (exact straggler
counts) used by the Fig. 1/6/7 benchmarks, mirroring the paper's local
cluster where straggler behavior was precisely controlled.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TraceConfig", "sample_traces", "controlled_traces", "train_test_split"]


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    n_nodes: int = 12
    n_iters: int = 300
    base_low: float = 0.8          # non-straggler heterogeneity: ±20 %
    base_high: float = 1.0
    drift_theta: float = 0.25      # OU mean reversion
    drift_sigma: float = 0.02      # ~within 10% over ~10 samples
    noise_sigma: float = 0.01      # iid measurement noise
    straggler_slowdown: float = 5.0
    p_become_straggler: float = 0.01   # per-iteration regime switch prob
    p_recover: float = 0.10
    floor: float = 0.02


def sample_traces(cfg: TraceConfig, seed: int = 0) -> np.ndarray:
    """Sample (n_iters, n_nodes) speed traces from the generative model."""
    rng = np.random.default_rng(seed)
    n, t = cfg.n_nodes, cfg.n_iters
    base = rng.uniform(cfg.base_low, cfg.base_high, size=n)
    drift = np.zeros(n)
    straggler = np.zeros(n, dtype=bool)
    out = np.empty((t, n), dtype=np.float64)
    for it in range(t):
        # regime switching
        switch_on = rng.random(n) < cfg.p_become_straggler
        switch_off = rng.random(n) < cfg.p_recover
        straggler = np.where(straggler, ~switch_off, switch_on)
        # OU drift around 0 (multiplicative, in log space)
        drift += -cfg.drift_theta * drift + cfg.drift_sigma * rng.standard_normal(n)
        speed = base * np.exp(drift)
        speed = np.where(straggler, speed / cfg.straggler_slowdown, speed)
        speed *= 1.0 + cfg.noise_sigma * rng.standard_normal(n)
        out[it] = np.maximum(speed, cfg.floor)
    return out


def controlled_traces(n_nodes: int, n_iters: int, n_stragglers: int,
                      nonstraggler_variation: float = 0.2,
                      straggler_slowdown: float = 5.0,
                      drift_sigma: float = 0.01,
                      seed: int = 0) -> np.ndarray:
    """Controlled-cluster scenario: exactly ``n_stragglers`` persistent
    stragglers (the last nodes), non-stragglers spread uniformly over
    [1 - variation, 1] with small drift — the paper's §7.1 setup."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(1.0 - nonstraggler_variation, 1.0, size=n_nodes)
    # fastest non-straggler pinned to 1.0 so the 5x slowdown is relative to it
    base[np.argmax(base[: n_nodes - n_stragglers] if n_stragglers else base)] = 1.0
    if n_stragglers:
        base[-n_stragglers:] = 1.0 / straggler_slowdown
    drift = drift_sigma * rng.standard_normal((n_iters, n_nodes))
    out = base[None, :] * np.exp(np.cumsum(drift, axis=0) * 0.1)
    return np.maximum(out, 0.01)


def train_test_split(traces: np.ndarray, frac: float = 0.8):
    """Paper's 80:20 split along the time axis."""
    t = traces.shape[0]
    cut = int(t * frac)
    return traces[:cut], traces[cut:]
