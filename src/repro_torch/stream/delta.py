"""Merge-join delta state for the fused ingest path (DESIGN.md §7).

The general incremental join in ``engine._delta_join`` evaluates each
telescoping term with the dense per-reducer einsum of
``mapreduce.local_join.local_join_count_checksum``.  That einsum pads every
reducer to the capacity of the *hottest* bin, so under skew (the whole point
of SharesSkew) each batch pays O(K * cap_state * cap_batch) — quadratic in
stream length and, worse, proportional to padding that holds no tuples.

For the dominant streaming case — two relations joined on a single shared
column — the same sums collapse to an order-free contraction over exact
key groups:

    count_term = |{(a, b) : dest_a = dest_b, val_a = val_b}|
    chk_term   = sum over those pairs of w_a * w_b   (mod 2^32)

Both are computed exactly from a per-relation array of emissions sorted by
the composite key ``dest << 32 | joinval``: ``searchsorted`` finds each
probe's group, and prefix sums of counts / mod-2^32 weights finish the
contraction in O((M + E) log M).  Integer sums are order-independent and
uint32 arithmetic wraps exactly like the int32 einsum accumulation, so the
result is bit-identical to the einsum path — this is an *algorithmic*
re-association of the very same sum, not an approximation.

The index is maintained incrementally: appending a batch is a host-side
sorted merge (O(M + E) memcpy), never a re-sort of history; only a replan
rebuilds it from scratch, mirroring how ``engine`` treats its binned state.
Queries with >2 relations or multi-column links keep the einsum path.

Each entry carries the id of the batch that contributed it, so windowed
retention (DESIGN.md §8) can ``expire`` one batch's emissions exactly — a
boolean-mask compaction over the retained arrays, O(M), no re-sort and no
re-route.  Expiry plus the engine's retraction probes keep the windowed
fingerprint bit-identical to the einsum path on the retained suffix.
"""
from __future__ import annotations

import numpy as np

from repro_torch.mapreduce.hashing import row_weight_np
from repro_torch.mapreduce.local_join import LocalJoinSpec


def _keys(dest: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Composite sort key: reducer id in the high 32 bits, join value
    (zero-extended uint32 bit pattern) in the low 32."""
    return (dest.astype(np.int64) << 32) | vals.astype(np.uint32).astype(np.int64)


class SortedDeltaIndex:
    """Per-relation sorted emission index for exact merge-join deltas.

    Holds, per relation, the flat routed emissions of the accumulated
    stream sorted by ``(dest, join_value)`` with their mod-2^32 row
    weights aligned.  ``probe`` evaluates one telescoping term against a
    relation's current index; ``append`` folds a batch in.
    """

    @staticmethod
    def eligible(spec: LocalJoinSpec) -> bool:
        """True for binary joins with exactly one shared column."""
        return (
            len(spec.rel_names) == 2
            and len(spec.links) == 1
            and len(spec.links[0][2]) == 1
        )

    def __init__(self, spec: LocalJoinSpec, weight_seed: int = 0x5EED):
        if not self.eligible(spec):
            raise ValueError("SortedDeltaIndex requires a binary 1-column link")
        ((_, _, ((col_l, col_r),)),) = spec.links
        self.rel_names = spec.rel_names
        # join column + weight seed per relation (seed offset = index in
        # spec.rel_names, matching local_join_count_checksum exactly)
        self._col = {spec.rel_names[0]: col_l, spec.rel_names[1]: col_r}
        self._seed = {nm: weight_seed + i for i, nm in enumerate(spec.rel_names)}
        self._keys_by_rel: dict[str, np.ndarray] = {}
        self._weights_by_rel: dict[str, np.ndarray] = {}
        self._batch_by_rel: dict[str, np.ndarray] = {}  # contributing batch id
        for nm in spec.rel_names:
            self.clear(nm)

    # ---- maintenance -------------------------------------------------------
    def _flat(
        self, name: str, dest: np.ndarray, rows: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """(sorted keys, aligned weights) of one batch of emissions."""
        if dest.size == 0:
            return np.empty(0, np.int64), np.empty(0, np.uint32)
        keys = _keys(dest, rows[:, self._col[name]])
        w = row_weight_np(rows, self._seed[name]).astype(np.uint32)
        order = np.argsort(keys, kind="stable")
        return keys[order], w[order]

    def clear(self, name: str) -> None:
        """Reset a relation's index from scratch (replan migration rebuilds
        by re-appending each retained batch with its id)."""
        self._keys_by_rel[name] = np.empty(0, np.int64)
        self._weights_by_rel[name] = np.empty(0, np.uint32)
        self._batch_by_rel[name] = np.empty(0, np.int64)

    def rebuild(
        self, name: str, dest: np.ndarray, rows: np.ndarray, batch_id: int = 0
    ) -> None:
        """Reset a relation's index to exactly one batch of emissions."""
        self.clear(name)
        self.append(name, dest, rows, batch_id)

    def append(
        self, name: str, dest: np.ndarray, rows: np.ndarray, batch_id: int = 0
    ) -> None:
        """Sorted-merge a batch of emissions into a relation's index."""
        if dest.size == 0:
            return
        new_keys, new_w = self._flat(name, dest, rows)
        keys = self._keys_by_rel[name]
        pos = np.searchsorted(keys, new_keys, side="right")
        self._keys_by_rel[name] = np.insert(keys, pos, new_keys)
        self._weights_by_rel[name] = np.insert(
            self._weights_by_rel[name], pos, new_w
        )
        self._batch_by_rel[name] = np.insert(
            self._batch_by_rel[name], pos, np.int64(batch_id)
        )

    def drop_reducers(self, name: str, reducer_ids: np.ndarray) -> int:
        """Remove every entry destined for the given reducers — the index
        half of simulated reducer loss (DESIGN.md §5).  The composite key
        carries the destination in its high 32 bits, so lost entries are a
        boolean-mask compaction, exactly like ``expire``; lineage replay
        re-appends the survivors' share batch-by-batch afterwards.
        Returns the number removed."""
        reducer_ids = np.asarray(reducer_ids, dtype=np.int64)
        keys = self._keys_by_rel[name]
        if keys.size == 0 or reducer_ids.size == 0:
            return 0
        keep = ~np.isin(keys >> 32, reducer_ids)
        removed = int(keys.size - keep.sum())
        if removed:
            self._keys_by_rel[name] = keys[keep]
            self._weights_by_rel[name] = self._weights_by_rel[name][keep]
            self._batch_by_rel[name] = self._batch_by_rel[name][keep]
        return removed

    def expire(self, name: str, batch_id: int) -> int:
        """Remove every entry batch ``batch_id`` contributed to a relation's
        index (windowed retention).  Returns the number removed."""
        ids = self._batch_by_rel[name]
        keep = ids != np.int64(batch_id)
        removed = int(ids.size - keep.sum())
        if removed:
            self._keys_by_rel[name] = self._keys_by_rel[name][keep]
            self._weights_by_rel[name] = self._weights_by_rel[name][keep]
            self._batch_by_rel[name] = ids[keep]
        return removed

    # ---- the contraction ---------------------------------------------------
    def probe(
        self, name: str, probe_name: str, dest: np.ndarray, rows: np.ndarray
    ) -> tuple[int, int]:
        """Join the probe emissions (from ``probe_name``) against relation
        ``name``'s current index.  Returns (count, checksum mod 2^32) —
        bit-identical to the corresponding einsum telescoping term."""
        keys = self._keys_by_rel[name]
        w_state = self._weights_by_rel[name]
        if dest.size == 0 or keys.size == 0:
            return 0, 0
        pkeys = _keys(dest, rows[:, self._col[probe_name]])
        w_probe = row_weight_np(rows, self._seed[probe_name]).astype(np.uint32)
        lo = np.searchsorted(keys, pkeys, side="left")
        hi = np.searchsorted(keys, pkeys, side="right")
        count = int(np.sum((hi - lo).astype(np.int64)))
        wpref = np.concatenate(
            [np.zeros(1, np.uint32), np.cumsum(w_state, dtype=np.uint32)]
        )
        group_w = wpref[hi] - wpref[lo]  # uint32 wraparound, exact mod 2^32
        chk = int(np.sum(w_probe * group_w, dtype=np.uint32))
        return count, chk
