"""MDS coded-computation primitives (the algebra layer of S²C²), for PyTorch.

An (n, k)-MDS code over the reals is specified by a generator matrix
``G ∈ R^{n×k}`` whose every k×k row-submatrix is nonsingular ("any k of n"
property).  A data matrix ``A ∈ R^{D×d}`` is split row-wise into k blocks
``A_0..A_{k-1}`` of ``D/k`` rows each; worker ``w`` stores the coded
partition ``Ã_w = Σ_i G[w, i] · A_i``.  Any k worker results ``Ã_w x``
suffice to recover all ``A_i x`` by solving the k×k system.

Generator constructions: ``systematic_cauchy`` (default, ``G = [I_k ; C]``
with a row-normalised Cauchy parity block), ``vandermonde`` (the paper's
textbook construction) and ``chebyshev_vandermonde``.  The generator and
all decode weights are numpy float64, solved on the host; only encoding
touches tensors, through the ``mds_encode`` kernel on a CUDA device.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops

__all__ = [
    "MDSCode",
    "make_generator",
    "encode_blocks",
    "encode_matrix",
    "decode_matrix",
    "decode_from_any_k",
    "pad_rows",
    "split_rows",
]


# ---------------------------------------------------------------------------
# Generator construction
# ---------------------------------------------------------------------------

def _cauchy_parity(n: int, k: int, dtype=np.float64) -> np.ndarray:
    """Cauchy block C[i, j] = 1 / (x_i + y_j), x, y disjoint positive sets."""
    m = n - k
    # x_i and y_j must be pairwise distinct with x_i + y_j != 0.
    x = np.arange(1, m + 1, dtype=dtype)  # parity node ids
    y = np.arange(m + 1, m + k + 1, dtype=dtype)  # systematic node ids
    c = 1.0 / (x[:, None] + y[None, :])
    # Row-scale so each parity row sums to 1 -> keeps encoded magnitudes
    # comparable to the data blocks (pure row scaling preserves MDS).
    c = c / c.sum(axis=1, keepdims=True)
    return c


def make_generator(n: int, k: int, kind: str = "systematic_cauchy",
                   dtype=np.float64) -> np.ndarray:
    """Return an (n, k) real MDS generator matrix as a numpy array."""
    if not 1 <= k <= n:
        raise ValueError(f"need 1 <= k <= n, got n={n}, k={k}")
    if kind == "systematic_cauchy":
        if n == k:
            return np.eye(k, dtype=dtype)
        g = np.concatenate([np.eye(k, dtype=dtype), _cauchy_parity(n, k, dtype)], axis=0)
    elif kind == "vandermonde":
        # Paper-style: evaluation points 0..n-1, G[w, i] = w**i.
        pts = np.arange(n, dtype=dtype)
        g = pts[:, None] ** np.arange(k, dtype=dtype)[None, :]
    elif kind == "chebyshev_vandermonde":
        pts = np.cos((2 * np.arange(n, dtype=dtype) + 1) * np.pi / (2 * n))
        g = pts[:, None] ** np.arange(k, dtype=dtype)[None, :]
    else:
        raise ValueError(f"unknown generator kind: {kind!r}")
    return np.ascontiguousarray(g, dtype=dtype)


def _check_mds(g: np.ndarray, trials: int = 64, seed: int = 0) -> bool:
    """Spot-check the any-k property on random k-subsets (full check is
    combinatorial; Cauchy/Vandermonde are MDS by construction)."""
    n, k = g.shape
    rng = np.random.default_rng(seed)
    for _ in range(trials):
        rows = rng.choice(n, size=k, replace=False)
        if abs(np.linalg.slogdet(g[rows])[0]) < 0.5:  # sign 0 => singular
            return False
    return True


# ---------------------------------------------------------------------------
# Row partitioning helpers
# ---------------------------------------------------------------------------

def pad_rows(a: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero-pad rows of ``a`` so the row count divides ``multiple``."""
    rem = (-a.shape[0]) % multiple
    if rem == 0:
        return a
    return torch.cat([a, a.new_zeros((rem,) + tuple(a.shape[1:]))], dim=0)


def split_rows(a: torch.Tensor, k: int) -> torch.Tensor:
    """Split rows into k equal blocks -> shape (k, D/k, ...). Rows must divide k."""
    d = a.shape[0]
    if d % k:
        raise ValueError(f"rows {d} not divisible by k={k}; use pad_rows first")
    return a.reshape((k, d // k) + tuple(a.shape[1:]))


# ---------------------------------------------------------------------------
# Encode / decode
# ---------------------------------------------------------------------------

def encode_blocks(g: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
    """Encode k data blocks into n coded partitions.

    g: (n, k); blocks: (k, rows, ...) -> (n, rows, ...).  On a CUDA device
    this is one ``mds_encode`` kernel launch.
    """
    return ops.mds_encode(g.to(blocks.dtype), blocks.contiguous())


def encode_matrix(g: torch.Tensor, a: torch.Tensor, k: int) -> torch.Tensor:
    """Split ``a`` row-wise into k blocks and encode into n partitions."""
    return encode_blocks(g, split_rows(a, k))


def decode_matrix(g: np.ndarray, workers: Sequence[int]) -> np.ndarray:
    """Inverse of the k×k generator row-submatrix for a completion set.

    Host-side (numpy, float64): the decode matrix is computed once per
    observed completion pattern and then applied on the device.
    """
    workers = np.asarray(workers)
    k = g.shape[1]
    if workers.shape[0] != k:
        raise ValueError(f"need exactly k={k} workers, got {workers.shape[0]}")
    sub = np.asarray(g, dtype=np.float64)[workers]
    # LU solve against the identity RHS instead of an explicit inverse:
    # better conditioned and the same primitive the batched path uses.
    return np.linalg.solve(sub, np.eye(k, dtype=np.float64))


def decode_from_any_k(g_sub: torch.Tensor, results: torch.Tensor) -> torch.Tensor:
    """Recover the k data-block products from k coded results.

    g_sub: (k, k) generator rows of the responding workers.
    results: (k, rows, ...) coded partial products  Ã_w x.
    Returns (k, rows, ...) = the uncoded block products A_i x, in results'
    dtype; solved in float64 when g_sub is float64, else in float32.
    """
    k = results.shape[0]
    dtype = torch.float64 if g_sub.dtype == torch.float64 else torch.float32
    flat = results.reshape(k, -1).to(dtype)
    sol = torch.linalg.solve(g_sub.to(device=flat.device, dtype=dtype), flat)
    return sol.reshape(results.shape).to(results.dtype)


# ---------------------------------------------------------------------------
# MDSCode: the user-facing bundle
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MDSCode:
    """An (n, k)-MDS code with helpers bound to a concrete generator.

    Decode weights are cached per instance: responder sets repeat heavily
    across rounds, so both the k×k decode submatrices (keyed by responder-id
    tuple) and fully-assembled per-round weight tables (keyed by the whole
    (chunks, k) responder pattern) live in thread-safe LRU caches.  Misses
    are solved in one batched ``np.linalg.solve`` per call.
    """

    n: int
    k: int
    kind: str = "systematic_cauchy"

    _SUBMAT_CACHE_CAP = 4096        # distinct responder k-tuples
    _PATTERN_CACHE_CAP = 512        # distinct full-round coverage patterns

    def __post_init__(self):
        g = make_generator(self.n, self.k, self.kind)
        if not _check_mds(g):
            raise ValueError(f"generator ({self.n},{self.k},{self.kind}) failed MDS spot-check")
        object.__setattr__(self, "_g", g)
        # LRU caches + stats; mutable state on a frozen dataclass is fine —
        # hash/eq stay keyed on (n, k, kind) only.
        object.__setattr__(self, "_cache_lock", threading.Lock())
        object.__setattr__(self, "_submat_cache", OrderedDict())
        object.__setattr__(self, "_pattern_cache", OrderedDict())
        object.__setattr__(self, "_cache_stats", {"hits": 0, "misses": 0})

    @property
    def generator(self) -> np.ndarray:
        return self._g  # type: ignore[attr-defined]

    # -- encoding ----------------------------------------------------------
    def encode(self, a: torch.Tensor) -> torch.Tensor:
        """(D, d) -> (n, D/k, d) coded partitions (rows padded if needed),
        on a's device and in a's dtype."""
        a = pad_rows(a, self.k)
        g = torch.as_tensor(self.generator).to(device=a.device, dtype=a.dtype)
        return encode_matrix(g, a, self.k)

    # -- decoding ----------------------------------------------------------
    def decode_matrix(self, workers: Sequence[int]) -> np.ndarray:
        return decode_matrix(self.generator, workers)

    def decode(self, results: torch.Tensor, workers: Sequence[int]) -> torch.Tensor:
        """results: (k, rows, ...) from the given k workers -> decoded blocks,
        on results' device and in its dtype."""
        dm = torch.as_tensor(self.decode_matrix(workers)).to(device=results.device,
                                                             dtype=results.dtype)
        flat = results.reshape(self.k, -1)
        return (dm @ flat).reshape(results.shape)

    def decode_concat(self, results: torch.Tensor, workers: Sequence[int]) -> torch.Tensor:
        """Decode and concatenate blocks back into the original row order."""
        blocks = self.decode(results, workers)
        return blocks.reshape((-1,) + tuple(blocks.shape[2:]))

    # -- chunked (S²C²) decoding -------------------------------------------
    def _coverage_ids(self, coverage: np.ndarray) -> np.ndarray:
        """(num_chunks, n) bool coverage -> (num_chunks, k) first-k ids."""
        coverage = np.asarray(coverage, dtype=bool)
        num_chunks, n = coverage.shape
        if n != self.n:
            raise ValueError(f"coverage has n={n}, code has n={self.n}")
        counts = coverage.sum(axis=1)
        if (counts < self.k).any():
            c = int(np.argmax(counts < self.k))
            raise ValueError(
                f"chunk {c} covered by {int(counts[c])} < k={self.k} workers: "
                "S²C² decodability violated")
        # stable argsort on ~coverage puts covered ids first, ascending —
        # "the first k covering workers", sorted
        return np.argsort(~coverage, axis=1, kind="stable")[:, : self.k]

    def decode_submats(self, ids: np.ndarray,
                       use_cache: bool = True) -> np.ndarray:
        """Batched decode submatrices for responder-id rows.

        ids: (num_chunks, k) int — each row the k responders of one chunk,
        in the column order the caller will feed partials.  Returns
        D: (num_chunks, k, k) with ``D[c] @ partials_of(ids[c])`` the
        decoded chunk blocks.  Rows repeating a responder tuple hit the
        per-tuple LRU; all misses are solved in ONE batched
        ``np.linalg.solve`` call.
        """
        ids = np.asarray(ids, dtype=np.int64)
        num_chunks, k = ids.shape
        if k != self.k:
            raise ValueError(f"ids has k={k}, code has k={self.k}")
        uniq, inverse = np.unique(ids, axis=0, return_inverse=True)
        u = uniq.shape[0]
        dms = np.empty((u, k, k), dtype=np.float64)
        missing: list = []              # (slot, tuple) pairs to solve
        if use_cache:
            with self._cache_lock:
                cache = self._submat_cache
                for i in range(u):
                    key = tuple(int(v) for v in uniq[i])
                    hit = cache.get(key)
                    if hit is not None:
                        cache.move_to_end(key)
                        dms[i] = hit
                    else:
                        missing.append((i, key))
                self._cache_stats["hits"] += u - len(missing)
                self._cache_stats["misses"] += len(missing)
        else:
            missing = [(i, tuple(int(v) for v in uniq[i])) for i in range(u)]
        if missing:
            slots = np.array([i for i, _ in missing], dtype=np.int64)
            subs = self._g[uniq[slots]]                 # (m, k, k)
            eye = np.empty_like(subs)
            eye[:] = np.eye(k, dtype=np.float64)
            solved = np.linalg.solve(subs, eye)         # one batched LU
            dms[slots] = solved
            if use_cache:
                with self._cache_lock:
                    cache = self._submat_cache
                    for (_, key), dm in zip(missing, solved):
                        cache[key] = dm
                    while len(cache) > self._SUBMAT_CACHE_CAP:
                        cache.popitem(last=False)
        return dms[inverse.reshape(-1)]

    def chunk_decode_weights(self, coverage: np.ndarray,
                             use_cache: bool = True) -> np.ndarray:
        """Per-chunk decode weights for S²C² partial results.

        coverage: (num_chunks, n) boolean — worker w computed chunk c.
        Returns W: (num_chunks, k, n) such that for chunk c,
        ``W[c] @ partials[:, c]`` recovers the k data-block chunk products,
        using (the first) k covering workers; zero columns elsewhere.

        Raises if some chunk is covered by fewer than k workers.  Results
        for a whole coverage pattern are LRU-cached; the returned array is
        shared with the cache and must not be mutated by the caller.
        """
        ids = self._coverage_ids(coverage)
        key = None
        if use_cache:
            key = ids.tobytes()
            with self._cache_lock:
                hit = self._pattern_cache.get(key)
                if hit is not None:
                    self._pattern_cache.move_to_end(key)
                    self._cache_stats["hits"] += 1
                    return hit
                self._cache_stats["misses"] += 1
        num_chunks = ids.shape[0]
        dms = self.decode_submats(ids, use_cache=use_cache)
        w = np.zeros((num_chunks, self.k, self.n), dtype=np.float64)
        idx = np.broadcast_to(ids[:, None, :], dms.shape)
        np.put_along_axis(w, idx, dms, axis=2)
        if use_cache:
            w.setflags(write=False)     # shared with the cache
            with self._cache_lock:
                self._pattern_cache[key] = w
                while len(self._pattern_cache) > self._PATTERN_CACHE_CAP:
                    self._pattern_cache.popitem(last=False)
        return w

    def chunk_decode_weights_compact(
            self, coverage: np.ndarray,
            use_cache: bool = True) -> Tuple[np.ndarray, np.ndarray]:
        """Compact variant: (D: (num_chunks, k, k), ids: (num_chunks, k)).

        ``D[c] @ partials[ids[c], c]`` recovers chunk c's data blocks —
        the decode hot path, which never materializes the zero columns of
        the full (num_chunks, k, n) table.
        """
        ids = self._coverage_ids(coverage)
        return self.decode_submats(ids, use_cache=use_cache), ids

    def decode_cache_info(self) -> dict:
        """Cache observability: hits/misses plus current sizes."""
        with self._cache_lock:
            return {**self._cache_stats,
                    "submats": len(self._submat_cache),
                    "patterns": len(self._pattern_cache)}

    def decode_cache_clear(self) -> None:
        with self._cache_lock:
            self._submat_cache.clear()
            self._pattern_cache.clear()
            self._cache_stats.update(hits=0, misses=0)
