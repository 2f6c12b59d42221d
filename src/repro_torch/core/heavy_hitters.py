"""Heavy-hitter identification (the paper's preliminary round).

Two paths:
  * exact -- np.unique over a column (what the experiments use; the paper's
    preliminary MapReduce round computes exactly this histogram),
  * CountMinSketch -- mergeable sketch for the 1000+-node posture, where each
    host sketches its shard and sketches are summed; candidate extraction
    keeps values whose estimate crosses the threshold.

A value is a heavy hitter when its frequency would overload one reducer:
count >= threshold, with threshold defaulting to the reducer capacity q
(paper §4: q bounds the inputs per reducer).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

_P = (1 << 61) - 1  # Mersenne prime for universal hashing


@dataclasses.dataclass(frozen=True)
class HeavyHitters:
    """HH values and their per-relation counts for one attribute."""

    attr: str
    values: tuple[int, ...]
    counts: tuple[int, ...]  # max count over relations containing attr

    def __contains__(self, v: int) -> bool:
        return v in self.values


def exact_heavy_hitters(column: np.ndarray, threshold: float) -> tuple[np.ndarray, np.ndarray]:
    """Values with count >= threshold, sorted by count descending."""
    if column.size == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    vals, counts = np.unique(np.asarray(column), return_counts=True)
    mask = counts >= threshold
    vals, counts = vals[mask], counts[mask]
    order = np.argsort(-counts, kind="stable")
    return vals[order].astype(np.int64), counts[order].astype(np.int64)


class CountMinSketch:
    """Mergeable count-min sketch over int64 keys (Cormode-Muthukrishnan).

    update() is vectorized; estimates are upper bounds with
    P[err > eps*N] <= delta for width=ceil(e/eps), depth=ceil(ln 1/delta).
    """

    def __init__(self, width: int = 4096, depth: int = 5, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.width = int(width)
        self.depth = int(depth)
        # universal hash params (odd a avoids degenerate maps)
        self._a = (rng.integers(1, _P, size=depth, dtype=np.int64) | 1)
        self._b = rng.integers(0, _P, size=depth, dtype=np.int64)
        self.table = np.zeros((depth, width), dtype=np.int64)
        self.total = 0

    @classmethod
    def from_error(cls, eps: float, delta: float, seed: int = 0) -> "CountMinSketch":
        """Smallest sketch with P[estimate - count > eps*N] <= delta:
        width = ceil(e/eps), depth = ceil(ln 1/delta)."""
        width = int(math.ceil(math.e / eps))
        depth = int(math.ceil(math.log(1.0 / delta)))
        return cls(width=width, depth=max(1, depth), seed=seed)

    def _buckets(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, dtype=np.int64)
        # (a*x + b) mod p mod w, via python-int math safe from overflow
        out = np.empty((self.depth, keys.size), dtype=np.int64)
        for i in range(self.depth):
            h = (keys.astype(object) * int(self._a[i]) + int(self._b[i])) % _P
            out[i] = (h % self.width).astype(np.int64)
        return out

    def update(self, keys: np.ndarray) -> None:
        b = self._buckets(keys)
        for i in range(self.depth):
            np.add.at(self.table[i], b[i], 1)
        self.total += int(np.asarray(keys).size)

    def estimate(self, keys: np.ndarray) -> np.ndarray:
        b = self._buckets(keys)
        est = np.min(
            np.stack([self.table[i][b[i]] for i in range(self.depth)]), axis=0
        )
        return est

    def merge(self, other: "CountMinSketch") -> "CountMinSketch":
        if (self.width, self.depth) != (other.width, other.depth):
            raise ValueError("sketch shapes must match to merge")
        if not (np.array_equal(self._a, other._a) and np.array_equal(self._b, other._b)):
            raise ValueError("sketch hash seeds must match to merge")
        out = CountMinSketch(self.width, self.depth)
        out._a, out._b = self._a, self._b
        out.table = self.table + other.table
        out.total = self.total + other.total
        return out

    def heavy_hitters(self, candidates: np.ndarray, threshold: float) -> tuple[np.ndarray, np.ndarray]:
        """Filter candidate values by estimated count >= threshold."""
        candidates = np.unique(np.asarray(candidates, dtype=np.int64))
        est = self.estimate(candidates)
        mask = est >= threshold
        vals, counts = candidates[mask], est[mask]
        order = np.argsort(-counts, kind="stable")
        return vals[order], counts[order]
