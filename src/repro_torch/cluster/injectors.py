"""Pluggable slowdown injectors that throttle *real* worker compute.

A worker asks its injector for the current speed ``s ∈ [0, 1]`` before each
chunk and stretches the chunk's wall time to ``rows · row_cost / s`` (the
matvec itself runs at native speed; the remainder is slept).  ``s == 0``
means the worker is dead from that point on: it silently stops responding
(fail-stop — no error report, exactly the failure model of §4.4).

Three families, mirroring the paper's evaluation conditions:

* :class:`TraceInjector` — trace-driven: per-(iteration, worker) speeds from
  a ``(T, n)`` array, e.g. ``repro_torch.core.traces.controlled_traces`` (the
  controlled local cluster) or ``sample_traces`` (the DigitalOcean model).
* :class:`BurstyInjector` — Markov bursts: workers alternate between full
  speed and a slowdown regime with given start/stop probabilities per
  iteration (the "transient straggler" condition of §7.1.2).
* :class:`FailStopInjector` — workers die at given iterations and never
  come back (§4.4 fault tolerance).
"""

from __future__ import annotations

import threading
from typing import Dict, Mapping, Optional, Protocol

import numpy as np

from repro_torch.cluster import obs

__all__ = ["SlowdownInjector", "NoSlowdown", "TraceInjector",
           "BurstyInjector", "FailStopInjector", "TracedInjector"]


class SlowdownInjector(Protocol):
    def speed(self, worker: int, iteration: int) -> float:
        """Current speed multiplier for ``worker`` during ``iteration``.

        1.0 = full speed, 0 < s < 1 = straggling (chunk time / s),
        0.0 = fail-stop (worker stops responding permanently).
        """
        ...


class NoSlowdown:
    """Everyone runs at full speed (the homogeneous-cluster baseline)."""

    def speed(self, worker: int, iteration: int) -> float:
        return 1.0


class TraceInjector:
    """Speeds come from a (T, n) trace; iterations past T reuse the last row."""

    def __init__(self, traces: np.ndarray):
        self.traces = np.asarray(traces, dtype=np.float64)
        if self.traces.ndim != 2:
            raise ValueError(f"traces must be (T, n), got {self.traces.shape}")

    @property
    def n_workers(self) -> int:
        return self.traces.shape[1]

    def speed(self, worker: int, iteration: int) -> float:
        it = min(int(iteration), self.traces.shape[0] - 1)
        return float(self.traces[it, worker])


class BurstyInjector:
    """Markov-switching bursts: FAST <-> STRAGGLER per worker per iteration.

    The regime sequence is generated lazily (deterministic per seed) so the
    injector can serve any iteration index; thread-safe because workers of
    different ids may ask concurrently.
    """

    def __init__(self, n_workers: int, slowdown: float = 5.0,
                 p_start: float = 0.08, p_stop: float = 0.25,
                 base_speeds: Optional[np.ndarray] = None, seed: int = 0):
        self.n = n_workers
        self.slowdown = float(slowdown)
        self.p_start = float(p_start)
        self.p_stop = float(p_stop)
        self.base = (np.ones(n_workers) if base_speeds is None
                     else np.asarray(base_speeds, dtype=np.float64))
        self._rng = np.random.default_rng(seed)
        self._state = np.zeros(n_workers, dtype=bool)   # True = straggling
        self._speeds: list[np.ndarray] = []             # per generated iter
        self._lock = threading.Lock()

    # picklable (multi-process transport ships injectors to worker
    # children): the lock is process-local state, recreated on unpickle
    def __getstate__(self):
        state = self.__dict__.copy()
        del state["_lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def _extend_to(self, iteration: int) -> None:
        while len(self._speeds) <= iteration:
            start = self._rng.random(self.n) < self.p_start
            stop = self._rng.random(self.n) < self.p_stop
            self._state = np.where(self._state, ~stop, start)
            s = np.where(self._state, self.base / self.slowdown, self.base)
            self._speeds.append(s)

    def speed(self, worker: int, iteration: int) -> float:
        with self._lock:
            self._extend_to(int(iteration))
            return float(self._speeds[int(iteration)][worker])


class FailStopInjector:
    """Workers die permanently at scheduled iterations; others follow an
    optional inner injector (default: full speed)."""

    def __init__(self, fail_at: Mapping[int, int],
                 inner: Optional[SlowdownInjector] = None):
        self.fail_at: Dict[int, int] = {int(w): int(it)
                                        for w, it in fail_at.items()}
        self.inner = inner if inner is not None else NoSlowdown()

    def speed(self, worker: int, iteration: int) -> float:
        die = self.fail_at.get(int(worker))
        if die is not None and iteration >= die:
            return 0.0
        return self.inner.speed(worker, iteration)


class TracedInjector:
    """Annotate the trace with the *injected* speed of every worker.

    Wraps any injector; each time a worker samples its speed the wrapper
    emits an ``inj_speed`` record (rendered as a per-worker counter track
    in the Chrome trace, next to the master's ``obs_speed`` measurements),
    so an injected-vs-observed slowdown mismatch — the predictor
    mispredicting a straggler — is visually attributable on the timeline.
    Emission is deduplicated per worker (only speed *changes* are
    recorded) and skipped entirely while the tracer is disabled, so the
    wrapper adds one dict lookup per chunk when idle.
    """

    def __init__(self, inner: SlowdownInjector, tracer: "obs.Tracer"):
        self.inner = inner
        self.tracer = tracer
        self._last: Dict[int, float] = {}   # guarded_by: _lock
        self._lock = threading.Lock()

    def speed(self, worker: int, iteration: int) -> float:
        s = self.inner.speed(worker, iteration)
        if self.tracer.enabled:
            with self._lock:
                changed = self._last.get(worker) != s
                if changed:
                    self._last[worker] = s
            if changed:
                self.tracer.emit(obs.KIND_INJ_SPEED, worker=worker,
                                 speed=s, iteration=iteration)
        return s
