"""Per-reducer load telemetry: the paper's own cost objective, observable
per batch (DESIGN.md §10).

SharesSkew's whole argument is about *load* — Beame–Koutris–Suciu
(arXiv:1401.1872) define it as the maximum bytes received by any one
reducer, and the skew variants of arXiv:1504.03247 are exactly the
regimes where that maximum detaches from the mean.  The engine has
always *routed* per-reducer arrivals; ``SkewScope`` makes them visible:

  * **exact per-reducer load** — tuples and bytes received per logical
    reducer for the current plan epoch, accumulated from the same
    ``_Routed.counts`` histograms the engine folds into carried state,
    so the tuple counts are bit-identical to the distributed shuffle's
    ``reducer_loads`` (asserted in ``pytest -m obs``).  Bytes are
    ``tuples x arity x 4`` per relation (int32 rows), summed;
  * **imbalance factor** — max/mean per-reducer load, the skew figure of
    merit (1.0 = perfectly balanced; the paper's q-bound argues this
    stays O(1) when heavy hitters are pinned);
  * **HH routing hit rate** — the fraction of ingested rows whose share-
    attribute value is pinned by the live plan, i.e. the share of traffic
    the skew machinery is actually absorbing;
  * **Count-Min estimate error** — the decayed CMS rate vs the *decay-
    weighted exact* counts over the retained window (the same geometric
    weights ``DecayingCountMin.rate`` applies), isolating pure sketch
    collision + window-truncation error: on a fully retained stream with
    no collisions the error is 0.

SkewScope mirrors the engine's ``_loads`` discipline: ``install(k)``
resets at every plan install (a replan changes the reducer id space) and
the migration re-route counts as arrivals, exactly like ``_loads``.  It
is process-local telemetry — not checkpointed; after a restore it
reflects the deterministic rebuild of the retained window.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

BYTES_PER_VALUE = 4  # int32 routing domain: every shipped cell is 4 bytes


@dataclasses.dataclass(frozen=True)
class SkewSnapshot:
    """One plan epoch's load picture (JSON-able)."""

    total_reducers: int
    total_tuples: int
    total_bytes: int
    max_tuples: int  # the BKS load: worst single reducer
    max_bytes: int
    mean_tuples: float
    imbalance: float  # max/mean tuples (1.0 when nothing arrived)
    hh_hit_rate: float  # pinned-HH share of ingested rows, cumulative
    cms_error: dict[str, float]  # per attr: mean relative rate error

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class SkewScope:
    """Per-reducer arrival accounting for the live plan epoch."""

    def __init__(self, arities: Mapping[str, int]):
        self.arities = {str(nm): int(a) for nm, a in arities.items()}
        self._tuples: dict[str, np.ndarray] = {}
        self._k = 0
        # cumulative HH-routing accounting (survives replans: it describes
        # the stream, not one plan's reducer id space)
        self.hh_rows = 0
        self.total_rows = 0
        self._cms_error: dict[str, float] = {}

    # ---- per-reducer loads -------------------------------------------------
    def install(self, total_reducers: int) -> None:
        """A plan (re)install: the reducer id space changed, start over —
        the mirror of the engine zeroing ``_loads``."""
        self._k = int(total_reducers)
        self._tuples = {
            nm: np.zeros(self._k, dtype=np.int64) for nm in self.arities
        }

    def record(self, rel_name: str, counts: np.ndarray) -> None:
        """Fold one routed batch's per-reducer arrival histogram for one
        relation (the ``_Routed.counts`` the engine already has)."""
        self._tuples[rel_name] += np.asarray(counts, dtype=np.int64)

    def tuples_per_reducer(self) -> np.ndarray:
        """[k] exact tuples received per logical reducer, all relations."""
        if not self._tuples:
            return np.zeros(0, dtype=np.int64)
        return np.sum(list(self._tuples.values()), axis=0, dtype=np.int64)

    def bytes_per_reducer(self) -> np.ndarray:
        """[k] exact bytes received per logical reducer (int32 rows)."""
        if not self._tuples:
            return np.zeros(0, dtype=np.int64)
        out = np.zeros(self._k, dtype=np.int64)
        for nm, t in self._tuples.items():
            out += t * (self.arities[nm] * BYTES_PER_VALUE)
        return out

    # ---- HH routing --------------------------------------------------------
    def record_hh(self, hh_rows: int, total_rows: int) -> None:
        self.hh_rows += int(hh_rows)
        self.total_rows += int(total_rows)

    @property
    def hh_hit_rate(self) -> float:
        return self.hh_rows / self.total_rows if self.total_rows else 0.0

    # ---- CMS error ---------------------------------------------------------
    def record_cms_error(self, errors: Mapping[str, float]) -> None:
        self._cms_error = {a: float(e) for a, e in errors.items()}

    # ---- snapshot ----------------------------------------------------------
    def snapshot(self) -> SkewSnapshot:
        t = self.tuples_per_reducer()
        b = self.bytes_per_reducer()
        total = int(t.sum())
        mean = total / self._k if self._k else 0.0
        mx = int(t.max()) if t.size else 0
        return SkewSnapshot(
            total_reducers=self._k,
            total_tuples=total,
            total_bytes=int(b.sum()),
            max_tuples=mx,
            max_bytes=int(b.max()) if b.size else 0,
            mean_tuples=mean,
            imbalance=(mx / mean) if mean > 0 else 1.0,
            hh_hit_rate=self.hh_hit_rate,
            cms_error=dict(sorted(self._cms_error.items())),
        )


# ---- free functions the engine feeds from its own state ---------------------
def hh_hit_counts(
    query, batch: Mapping[str, np.ndarray], hh_values: Mapping[str, Sequence[int]]
) -> tuple[int, int]:
    """(rows whose share-attribute value is pinned, total rows) for one
    admitted batch under the live plan's ``hh_values``.  A row counts as a
    hit when ANY of its pinned-attribute columns holds a pinned value —
    those rows route through a dedicated HH residual instead of the
    ordinary grid."""
    hits = total = 0
    pinned = {
        a: np.asarray(list(vals), dtype=np.int64)
        for a, vals in hh_values.items()
        if len(vals)
    }
    for rel in query.relations:
        rows = np.asarray(batch.get(rel.name, np.zeros((0, rel.arity))))
        n = rows.shape[0]
        total += n
        if n == 0:
            continue
        hit = np.zeros(n, dtype=bool)
        for a, vals in pinned.items():
            if a in rel.attrs:
                hit |= np.isin(rows[:, rel.index_of(a)], vals)
        hits += int(hit.sum())
    return hits, total


def cms_window_error(
    tracker,
    query,
    history: Mapping[str, Sequence[np.ndarray]],
    retained_ids: Sequence[int],
) -> dict[str, float]:
    """Per share-attribute mean relative error of the decayed Count-Min
    rate vs the decay-weighted EXACT counts over the retained window.

    The reference applies the same geometric weights as
    ``DecayingCountMin.rate`` — batch ``bid`` (0-based absolute index,
    ``T`` batches observed) contributes ``decay^(T-1-bid)`` times its
    exact value count, normalized by ``(1-g)/(1-g^T)`` — so on a window
    retaining the full stream the error isolates pure CMS collision
    overcount (always >= 0); an expired prefix shows up as the window-
    truncation share of the estimate.  Values audited are the tracker's
    own SpaceSaving candidates (threshold 0): exactly the set planning
    decisions are made from.
    """
    g = float(tracker.decay)
    T = int(tracker.batches)
    if T == 0:
        return {}
    norm = 1.0 / T if g >= 1.0 else (1.0 - g) / (1.0 - g**T)
    out: dict[str, float] = {}
    for attr in tracker.attrs:
        cand, _ = tracker.candidates_of(attr)
        if cand.size == 0:
            continue
        errs: list[float] = []
        for rel in query.relations_of(attr):
            col_idx = rel.index_of(attr)
            exact = np.zeros(cand.size, dtype=np.float64)
            for i, bid in enumerate(retained_ids):
                col = np.asarray(history[rel.name][i])[:, col_idx]
                if col.size == 0:
                    continue
                w = g ** (T - 1 - int(bid)) if g < 1.0 else 1.0
                vals, counts = np.unique(col, return_counts=True)
                pos = np.searchsorted(vals, cand)
                pos = np.clip(pos, 0, vals.size - 1)
                match = vals[pos] == cand
                exact += w * np.where(match, counts[pos], 0)
            exact *= norm
            est = tracker.rate_in(attr, rel.name, cand)
            denom = np.maximum(exact, 1e-12)
            errs.extend(np.abs(est - exact) / denom)
        if errs:
            out[attr] = float(np.mean(errs))
    return out
