"""Mergeable, decaying stream summaries for online heavy-hitter tracking
(DESIGN.md §6).

The batch planner sees all data up front and finds heavy hitters with one
exact scan (``core.heavy_hitters.exact_heavy_hitters``).  A streaming join
never sees "all data": the skew profile must be maintained incrementally
and must *forget*, so a value that was heavy an hour ago stops forcing a
pinned residual today.  Three layers:

  * ``DecayingCountMin`` — a ``core.heavy_hitters.CountMinSketch`` with a
    mix32 hash family (bit-identical on host numpy and on device via
    ``kernels.cms_update``) and exponential decay: before each batch the
    table is scaled by ``decay``, so counts converge to an EMA of per-batch
    frequencies.  ``rate()`` is the bias-corrected per-batch rate estimate.
  * ``SpaceSaving`` — Metwally et al.'s stream-summary with a fixed number
    of counters; generates the candidate set (CMS alone cannot enumerate
    which values to ask about).  Mergeable and decayable the same way.
  * ``StreamHHTracker`` — per share-attribute SpaceSaving candidates plus
    per (attribute, relation) DecayingCountMin rates, combined exactly like
    the batch detector: a value is a live HH when its estimated per-batch
    rate in ANY relation containing the attribute reaches the threshold.
"""
from __future__ import annotations

import dataclasses

import numpy as np

import torch

from repro_torch.core.dominance import share_attributes
from repro_torch.core.heavy_hitters import CountMinSketch
from repro_torch.core.schema import JoinQuery
from repro_torch.kernels.sketch_update import cms_update
from repro_torch.mapreduce.hashing import bucket_np


def _row_seeds(seed: int, depth: int) -> tuple[int, ...]:
    """Per-row mix32 seeds, reproducible from one integer seed."""
    rng = np.random.default_rng(seed)
    return tuple(int(s) for s in rng.integers(1, (1 << 31) - 1, size=depth))


def cms_delta(col: np.ndarray, seeds: tuple[int, ...], width: int) -> np.ndarray:
    """One column's [depth, width] Count-Min bucket-count increment.

    Integer counts over the mix32 family — bit-identical to what
    ``DecayingCountMin.update`` would add for the same column, so the
    result can be ``absorb``-ed by any sketch sharing ``(seeds, width)``.
    This is how a ``MultiQueryEngine`` computes ONE shared increment per
    relation batch and hands it to every tenant's tracker (DESIGN.md §9).
    """
    delta = np.zeros((len(seeds), int(width)), dtype=np.float64)
    col = np.asarray(col, dtype=np.int64)
    if col.size:
        for d, s in enumerate(seeds):
            buckets = bucket_np(col, s, int(width))
            delta[d] = np.bincount(buckets, minlength=int(width))
    return delta


class DecayingCountMin(CountMinSketch):
    """Count-Min over the mix32 row family with exponential decay.

    The bucket function matches ``kernels.cms_update`` bit-for-bit, so the
    per-batch table increment can be produced on-device and absorbed here.
    The table is float64: after ``step()`` it holds
    ``sum_t decay^(T-t) * c_t`` per bucket — a geometric average whose
    bias-corrected normalization ``(1-decay)/(1-decay^T)`` turns estimates
    into per-batch rates.
    """

    def __init__(
        self, width: int = 2048, depth: int = 4, seed: int = 0, decay: float = 0.5
    ):
        if not (0.0 < decay <= 1.0):
            raise ValueError("decay must be in (0, 1]")
        self.width = int(width)
        self.depth = int(depth)
        self.seeds = _row_seeds(seed, depth)
        self.decay_factor = float(decay)
        self.table = np.zeros((depth, width), dtype=np.float64)
        self.total = 0.0
        self.batches = 0

    # mix32 family instead of the Mersenne universal hashes of the parent
    def _buckets(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, dtype=np.int64)
        return np.stack([bucket_np(keys, s, self.width) for s in self.seeds])

    def step(self) -> None:
        """Advance one batch boundary: decay everything seen so far."""
        if self.decay_factor < 1.0:
            self.table *= self.decay_factor
            self.total *= self.decay_factor
        self.batches += 1

    def absorb(self, delta_table: np.ndarray, n: int) -> None:
        """Add a [depth, width] increment (e.g. from ``kernels.cms_update``)."""
        if delta_table.shape != self.table.shape:
            raise ValueError("increment shape must match sketch table")
        self.table += delta_table
        self.total += float(n)

    def rate(self, keys: np.ndarray) -> np.ndarray:
        """Bias-corrected per-batch rate estimates (upper bounds)."""
        if self.batches == 0:
            return np.zeros(np.asarray(keys).size)
        g = self.decay_factor
        norm = 1.0 / self.batches if g >= 1.0 else (1.0 - g) / (1.0 - g**self.batches)
        return self.estimate(keys) * norm

    def merge(self, other: "DecayingCountMin") -> "DecayingCountMin":
        if (self.width, self.depth) != (other.width, other.depth):
            raise ValueError("sketch shapes must match to merge")
        if self.seeds != other.seeds or self.decay_factor != other.decay_factor:
            raise ValueError("sketch seeds/decay must match to merge")
        out = DecayingCountMin(self.width, self.depth, decay=self.decay_factor)
        out.seeds = self.seeds
        out.table = self.table + other.table
        out.total = self.total + other.total
        out.batches = max(self.batches, other.batches)
        return out

    # ---- checkpoint (DESIGN.md §8) -----------------------------------------
    def state_dict(self) -> dict[str, np.ndarray]:
        return {
            "table": self.table.copy(),
            "scalars": np.array([self.total, float(self.batches)], np.float64),
        }

    def load_state_dict(self, state: dict[str, np.ndarray]) -> None:
        table = np.asarray(state["table"], dtype=np.float64)
        if table.shape != self.table.shape:
            raise ValueError("checkpointed sketch table shape mismatch")
        self.table = table.copy()
        scalars = np.asarray(state["scalars"])
        self.total = float(scalars[0])
        self.batches = int(scalars[1])


class SpaceSaving:
    """Stream-summary with ``capacity`` counters (Metwally et al. 2005).

    Guarantees: every value with true (decayed) count > total/capacity is
    retained; ``counts[v]`` overestimates by at most ``errors[v]``.
    """

    def __init__(self, capacity: int = 64):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self.counts: dict[int, float] = {}
        self.errors: dict[int, float] = {}

    def update(self, keys: np.ndarray) -> None:
        keys = np.asarray(keys, dtype=np.int64)
        if keys.size == 0:
            return
        vals, cnts = np.unique(keys, return_counts=True)
        # largest first so evictions never displace a bigger newcomer
        order = np.argsort(-cnts, kind="stable")
        for v, c in zip(vals[order].tolist(), cnts[order].tolist()):
            if v in self.counts:
                self.counts[v] += c
            elif len(self.counts) < self.capacity:
                self.counts[v] = float(c)
                self.errors[v] = 0.0
            else:
                victim = min(self.counts, key=self.counts.__getitem__)
                floor = self.counts.pop(victim)
                self.errors.pop(victim)
                self.counts[v] = floor + c
                self.errors[v] = floor

    def decay(self, factor: float) -> None:
        for v in self.counts:
            self.counts[v] *= factor
            self.errors[v] *= factor

    def merge(self, other: "SpaceSaving") -> "SpaceSaving":
        out = SpaceSaving(self.capacity)
        for src in (self, other):
            for v, c in src.counts.items():
                out.counts[v] = out.counts.get(v, 0.0) + c
                out.errors[v] = out.errors.get(v, 0.0) + src.errors[v]
        if len(out.counts) > out.capacity:
            keep = sorted(out.counts, key=out.counts.__getitem__, reverse=True)
            for v in keep[out.capacity :]:
                del out.counts[v], out.errors[v]
        return out

    def candidates(self) -> tuple[np.ndarray, np.ndarray]:
        """(values, counts) sorted by count descending."""
        if not self.counts:
            return np.empty(0, np.int64), np.empty(0, np.float64)
        items = sorted(self.counts.items(), key=lambda kv: -kv[1])
        vals = np.array([v for v, _ in items], dtype=np.int64)
        cnts = np.array([c for _, c in items], dtype=np.float64)
        return vals, cnts

    # ---- checkpoint (DESIGN.md §8) -----------------------------------------
    def state_dict(self) -> dict[str, np.ndarray]:
        """Counters in *insertion order* — eviction and candidate ordering
        tie-break on it, so preserving it makes restore bit-deterministic."""
        vals = np.array(list(self.counts), dtype=np.int64)
        return {
            "values": vals,
            "counts": np.array([self.counts[v] for v in vals], np.float64),
            "errors": np.array([self.errors[v] for v in vals], np.float64),
        }

    def load_state_dict(self, state: dict[str, np.ndarray]) -> None:
        vals = np.asarray(state["values"], dtype=np.int64)
        if vals.size > self.capacity:
            raise ValueError("checkpointed SpaceSaving exceeds capacity")
        self.counts = {
            int(v): float(c) for v, c in zip(vals, np.asarray(state["counts"]))
        }
        self.errors = {
            int(v): float(e) for v, e in zip(vals, np.asarray(state["errors"]))
        }


@dataclasses.dataclass(frozen=True)
class HHSnapshot:
    """Live heavy-hitter view for one attribute."""

    attr: str
    values: np.ndarray  # candidate values, rate-descending
    rates: np.ndarray  # per-batch rate estimates (max over relations)


class StreamHHTracker:
    """Per-attribute HH candidate tracking across micro-batches.

    ``observe(batch)`` decays all summaries one step and folds in the
    batch's join-attribute columns; ``snapshot()`` returns, per share
    attribute, candidates whose estimated per-batch rate crosses the
    threshold — the streaming analogue of ``detect_heavy_hitters``.
    """

    def __init__(
        self,
        query: JoinQuery,
        width: int = 2048,
        depth: int = 4,
        capacity: int = 64,
        decay: float = 0.5,
        seed: int = 0,
        use_device_sketch: bool = False,
        device: str | torch.device = "cuda",
    ):
        self.query = query
        self.device = torch.device(device)  # where use_device_sketch counts
        self.attrs = share_attributes(query)
        self.decay = float(decay)
        self.width = int(width)
        self.seeds = _row_seeds(seed, depth)  # shared by every CMS below
        self.use_device_sketch = bool(use_device_sketch)
        self._ss = {a: SpaceSaving(capacity) for a in self.attrs}
        self._cms: dict[tuple[str, str], DecayingCountMin] = {}
        for a in self.attrs:
            for rel in query.relations_of(a):
                self._cms[(a, rel.name)] = DecayingCountMin(
                    width, depth, seed=seed, decay=decay
                )
        self.batches = 0

    def observe(self, batch: dict[str, np.ndarray]) -> None:
        for cms in self._cms.values():
            cms.step()
        for a in self.attrs:
            self._ss[a].decay(self.decay)
        for a in self.attrs:
            for rel in self.query.relations_of(a):
                col = np.asarray(batch[rel.name])[:, rel.index_of(a)]
                cms = self._cms[(a, rel.name)]
                if self.use_device_sketch and col.size:
                    keys = torch.from_numpy(col.astype(np.int32)).to(self.device)
                    delta = cms_update(keys, cms.seeds, cms.width).cpu().numpy()
                    cms.absorb(delta.astype(np.float64), col.size)
                else:
                    cms.update(col)
                self._ss[a].update(col)
        self.batches += 1

    def observe_absorbed(
        self,
        batch: dict[str, np.ndarray],
        deltas: dict[tuple[str, str], np.ndarray],
    ) -> None:
        """``observe`` with the Count-Min increments precomputed elsewhere.

        ``deltas[(attr, rel_name)]`` is the [depth, width] bucket-count
        increment for that column — e.g. from the fused ingest kernel
        (``kernels.ingest_fused``), which shares this tracker's ``seeds``
        so tables stay bit-identical to the host ``observe`` path
        (integer counts are exact in float64).  SpaceSaving candidate
        tracking still runs host-side: it is a tiny dict update and needs
        the raw values, which the sketch buckets discard.
        """
        for cms in self._cms.values():
            cms.step()
        for a in self.attrs:
            self._ss[a].decay(self.decay)
        for a in self.attrs:
            for rel in self.query.relations_of(a):
                col = np.asarray(batch[rel.name])[:, rel.index_of(a)]
                self._cms[(a, rel.name)].absorb(
                    np.asarray(deltas[(a, rel.name)], dtype=np.float64), col.size
                )
                self._ss[a].update(col)
        self.batches += 1

    def candidates_of(self, attr: str) -> tuple[np.ndarray, np.ndarray]:
        """Public view of the SpaceSaving candidate set for ``attr`` —
        (values, decayed counts), count-descending.  This is the value set
        planning decisions are made from, and the set ``obs.skewscope``
        audits the sketch against."""
        return self._ss[attr].candidates()

    def rate_in(self, attr: str, rel_name: str, values: np.ndarray) -> np.ndarray:
        """Per-batch rate estimates for ``values`` in ONE relation's
        sketch.  ``rate_of`` takes the max over relations (the planning
        view); the CMS-error audit in ``obs.skewscope`` needs the
        per-relation estimate that exact per-relation counts compare to."""
        values = np.asarray(values, dtype=np.int64)
        if values.size == 0:
            return np.empty(0, np.float64)
        return self._cms[(attr, rel_name)].rate(values)

    def rate_of(self, attr: str, values: np.ndarray) -> np.ndarray:
        """Max per-batch rate over relations containing ``attr``."""
        values = np.asarray(values, dtype=np.int64)
        if values.size == 0:
            return np.empty(0, np.float64)
        rates = [
            self._cms[(attr, rel.name)].rate(values)
            for rel in self.query.relations_of(attr)
        ]
        return np.max(np.stack(rates), axis=0)

    def snapshot(self, threshold: float, max_per_attr: int = 8) -> dict[str, HHSnapshot]:
        out: dict[str, HHSnapshot] = {}
        for a in self.attrs:
            cand, _ = self._ss[a].candidates()
            if cand.size == 0:
                continue
            rates = self.rate_of(a, cand)
            mask = rates >= threshold
            if not mask.any():
                continue
            vals, rates = cand[mask], rates[mask]
            order = np.argsort(-rates, kind="stable")[:max_per_attr]
            out[a] = HHSnapshot(a, vals[order], rates[order])
        return out

    def hh_values(self, threshold: float, max_per_attr: int = 8) -> dict[str, np.ndarray]:
        """The ``plan_with_hh``-shaped view of ``snapshot``."""
        return {
            a: s.values for a, s in self.snapshot(threshold, max_per_attr).items()
        }

    # ---- checkpoint (DESIGN.md §8) -----------------------------------------
    def state_dict(self) -> dict[str, np.ndarray]:
        """Flat array tree of every summary — restoring it into a tracker
        built from the same config resumes estimation bit-for-bit."""
        out: dict[str, np.ndarray] = {
            "batches": np.array([self.batches], np.int64)
        }
        for (a, rel_name), cms in self._cms.items():
            for k, v in cms.state_dict().items():
                out[f"cms/{a}/{rel_name}/{k}"] = v
        for a, ss in self._ss.items():
            for k, v in ss.state_dict().items():
                out[f"ss/{a}/{k}"] = v
        return out

    def load_state_dict(self, state: dict[str, np.ndarray]) -> None:
        self.batches = int(np.asarray(state["batches"])[0])
        for (a, rel_name), cms in self._cms.items():
            cms.load_state_dict(
                {
                    "table": state[f"cms/{a}/{rel_name}/table"],
                    "scalars": state[f"cms/{a}/{rel_name}/scalars"],
                }
            )
        for a, ss in self._ss.items():
            ss.load_state_dict(
                {
                    "values": state[f"ss/{a}/values"],
                    "counts": state[f"ss/{a}/counts"],
                    "errors": state[f"ss/{a}/errors"],
                }
            )
