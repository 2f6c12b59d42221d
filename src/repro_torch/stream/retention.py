"""Windowed/TTL retention for carried streaming state (DESIGN.md §8).

The engine's carried reducer state is append-only under DESIGN.md §6's
semantics: every batch ever ingested stays resident so that future tuples
can join with it.  That is the demo simplification — an engine serving an
unbounded stream must *forget*.  Retention bounds carried state to a
sliding suffix of the stream (the retained **window**) defined by batch
count and/or wall-clock TTL, and changes the join semantics accordingly:
a new tuple joins only with retained partners.

Two fingerprints then coexist (both exact, both mod 2^32):

  * the **cumulative** fingerprint — every result the engine ever emitted
    (expiry never un-emits results already produced);
  * the **window** fingerprint — the join of the retained suffix alone,
    maintained incrementally by *retracting* each expiring batch's
    contribution: join(S ∪ E) − join(S) telescopes exactly like the
    insertion delta (term i = A_1..A_{i-1} ⋈ E_i ⋈ S_{i+1}..S_n with
    A = current state, E = expiring batch, S = survivors), and counts /
    orderless checksums subtract associatively mod 2^32.  The window
    fingerprint is what ``recompute_distributed(window=True)`` replays.

Expiry itself is pure host-side compute over state the tuples already
occupy — **no shuffle**: per-reducer bins are in batch-arrival order
(appends scatter at occupancy offsets, and replan rebuilds preserve row
order), so an expiring batch's emissions are exactly a *prefix* of every
reducer's bin and removal is a left shift (``remove_prefix``).  Bin
capacity is deliberately NOT shrunk here; compaction to tight capacity
rides the existing replan-migration rebuild, so retention adds no new
re-route of history.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

State = tuple[np.ndarray, np.ndarray, np.ndarray]  # (bins, valid, occup)


@dataclasses.dataclass(frozen=True)
class RetentionPolicy:
    """When does a retained batch expire?

    ``window_batches`` — keep at most the last W batches (None = unbounded).
    ``ttl_seconds``    — expire batches older than this on the engine's
                         clock (None = no TTL).  The engine's injectable
                         ``clock`` makes TTL deterministic under test.
    A batch expires when EITHER bound says so; both None (the default)
    reproduces the unbounded §6 baseline exactly.
    """

    window_batches: int | None = None
    ttl_seconds: float | None = None

    def __post_init__(self):
        if self.window_batches is not None and self.window_batches < 1:
            raise ValueError("window_batches must be >= 1")
        if self.ttl_seconds is not None and self.ttl_seconds <= 0:
            raise ValueError("ttl_seconds must be > 0")

    @property
    def enabled(self) -> bool:
        return self.window_batches is not None or self.ttl_seconds is not None

    def expired_prefix(
        self,
        retained_ids: Sequence[int],
        retained_ts: Sequence[float],
        next_batch_id: int,
        now: float,
    ) -> int:
        """How many of the oldest retained batches must expire *before*
        batch ``next_batch_id`` is ingested (so the window holds at most
        ``window_batches`` batches afterwards, all within TTL)."""
        n = len(retained_ids)
        drop = 0
        for i in range(n):
            out_of_window = (
                self.window_batches is not None
                and retained_ids[i] <= next_batch_id - self.window_batches
            )
            out_of_ttl = (
                self.ttl_seconds is not None
                and now - retained_ts[i] > self.ttl_seconds
            )
            if out_of_window or out_of_ttl:
                drop = i + 1
        return drop


def remove_prefix(state: State, counts: np.ndarray) -> State:
    """Drop the oldest ``counts[r]`` entries from the front of each reducer
    bin — the expiring batch's emissions, which sit at the head of every
    bin because appends are in batch-arrival order.  O(state) memmove,
    capacity unchanged (compaction happens at replan rebuild)."""
    bins, valid, occup = state
    counts = np.asarray(counts, dtype=occup.dtype)
    if counts.size == 0 or not counts.any():
        return state
    if np.any(counts > occup):
        raise ValueError("expiring more tuples than a reducer holds")
    k, cap = valid.shape
    new_occup = occup - counts
    # gather each bin shifted left by its own count; positions past the new
    # occupancy are cleared (the clip only touches already-masked slots)
    idx = np.minimum(np.arange(cap)[None, :] + counts[:, None], cap - 1)
    new_bins = np.take_along_axis(bins, idx[:, :, None], axis=1)
    new_valid = np.arange(cap)[None, :] < new_occup[:, None]
    new_bins[~new_valid] = 0
    return new_bins, new_valid, new_occup.astype(occup.dtype)


def lost_occupancy(states: dict[str, State], lost: np.ndarray) -> int:
    """The lost reducers' retained-window share: total emissions their
    bins held across all relations.  Lineage replay must reconstruct
    exactly this many tuples — the acceptance bound that distinguishes
    replay from a full-stream restore (DESIGN.md §5)."""
    lost = np.asarray(lost, dtype=np.int64)
    total = 0
    for _, _, occup in states.values():
        if occup.size and lost.size:
            total += int(occup[lost].sum())
    return total


def zero_reducers(state: State, lost: np.ndarray) -> State:
    """Clear the lost reducers' bins — the state-side materialization of a
    host loss (their carried tuples are unreachable).  Lineage replay then
    refills exactly these rows batch-by-batch; because appends scatter in
    batch-arrival order, the refilled bins are bit-identical to the bins
    the dead host carried."""
    lost = np.asarray(lost, dtype=np.int64)
    bins, valid, occup = state
    if lost.size == 0:
        return state
    bins, valid, occup = bins.copy(), valid.copy(), occup.copy()
    bins[lost] = 0
    valid[lost] = False
    occup[lost] = 0
    return bins, valid, occup


def select_reducers(
    dest: np.ndarray, lost: np.ndarray
) -> np.ndarray:
    """Boolean mask over one routed batch's emissions selecting those
    destined for the lost reducers — the per-batch lineage slice replay
    re-scatters."""
    if dest.size == 0 or np.asarray(lost).size == 0:
        return np.zeros(dest.shape, dtype=bool)
    return np.isin(dest, np.asarray(lost, dtype=dest.dtype))


def carried_tuples(states: dict[str, State]) -> tuple[int, int]:
    """(total retained emissions, worst per-reducer occupancy) across all
    relations — the soak metric that must stay flat under retention."""
    total, worst = 0, 0
    for _, _, occup in states.values():
        if occup.size:
            total += int(occup.sum())
            worst = max(worst, int(occup.max()))
    return total, worst
