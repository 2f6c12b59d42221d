"""Backpressure / admission control on streaming ingest (DESIGN.md §8).

The paper's capacity bound ``q`` is solved per batch: the plan guarantees
per-reducer arrivals ≈ q *for the batch size it was planned against*.  An
overloaded producer can hand the engine a batch far larger than that, and
the §6 engine would ship it anyway — blowing the VMEM/time budget the plan
was solved for.  Admission control turns overload into graceful
degradation with **exact accounting**:

  * Per relation, the per-batch admission budget is derived from the live
    plan and sketch: a plan with K reducers and replication width W_rel
    spreads ``n`` admitted rows into ~``n * W_rel / K`` arrivals per
    reducer, so the budget is ``headroom * q * K / W_rel`` rows — the
    largest batch the running plan can absorb within ``headroom`` × its
    solved capacity.  When the sketch predicts a *concentrated* hot value
    (an unpinned heavy hitter hashes to one grid coordinate — the overload
    signal of ``stream.drift``), the budget is tightened by the predicted
    concentration factor so a skewed inflow is throttled harder than a
    uniform one.
  * Arrivals beyond the budget are **deferred**: queued in a FIFO backlog,
    re-offered ahead of the next batch.  Joins are multiset-associative,
    so deferral never loses or duplicates results — it only shifts which
    batch emits them; the cumulative fingerprint after the backlog drains
    equals the oracle on everything admitted.
  * A backlog beyond ``max_backlog_rows`` is **shed** oldest-first, each
    drop counted per relation (``BatchReport.shed``).  Shedding is the
    only lossy action in the engine and is always explicit — the counters
    are exact, never sampled.

Everything is off by default (``AdmissionPolicy()`` admits unconditionally)
so the §6 baseline behavior is unchanged unless configured.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import numpy as np

from repro_torch.core.planner import SharesSkewPlan
from repro_torch.core.schema import JoinQuery


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Knobs for per-batch admission.  ``headroom=None`` (default) disables
    admission control entirely (admit everything, defer/shed nothing)."""

    headroom: float | None = None  # budget = headroom * q * K / W_rel rows
    max_backlog_rows: int = 100_000  # per relation; beyond this, shed
    min_admit: int = 32  # never starve a relation below this many rows

    def __post_init__(self):
        if self.headroom is not None and (
            not math.isfinite(self.headroom) or self.headroom <= 0
        ):
            raise ValueError(
                f"headroom must be finite and > 0, got {self.headroom}"
            )
        if self.max_backlog_rows < 0:
            raise ValueError("max_backlog_rows must be >= 0")
        if self.min_admit < 1:
            raise ValueError("min_admit must be >= 1")

    @property
    def enabled(self) -> bool:
        return self.headroom is not None


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    """Exact per-relation accounting for one batch boundary."""

    admitted: dict[str, int]  # rows entering the engine this batch
    deferred: dict[str, int]  # rows left queued in the backlog
    shed: dict[str, int]  # rows dropped (permanently) this batch
    budget: dict[str, int]  # the budget each relation was held to

    @property
    def total_deferred(self) -> int:
        return int(sum(self.deferred.values()))

    @property
    def total_shed(self) -> int:
        return int(sum(self.shed.values()))


def replication_width(plan: SharesSkewPlan, rel_name: str) -> int:
    """Total map-phase emission width of one relation under ``plan`` —
    Σ over residuals of the integer-share replication, i.e. the W in
    ``map_phase``'s [N, W] destination block."""
    rel = next(r for r in plan.query.relations if r.name == rel_name)
    return max(
        1, sum(res.int_replication(rel.attrs) for res in plan.residuals)
    )


class AdmissionController:
    """Stateless budget math + stateful FIFO backlog per relation."""

    def __init__(self, policy: AdmissionPolicy, query: JoinQuery, q: float):
        if not math.isfinite(q) or q <= 0:
            raise ValueError(
                f"admission needs a finite positive capacity q, got {q} "
                "(a zero/NaN q would silently zero every budget)"
            )
        self.policy = policy
        self.query = query
        self.q = float(q)
        self.backlog: dict[str, np.ndarray] = {
            r.name: np.zeros((0, r.arity), dtype=np.int64)
            for r in query.relations
        }
        self.total_deferred = 0  # rows that waited at least one batch
        self.total_shed = 0
        # degraded-mode tightening (DESIGN.md §5): after reducer loss the
        # engine sets this to surviving/provisioned host capacity, so
        # budgets shrink proportionally with the cluster — beyond the K/W
        # shrink the repaired plan already causes
        self.capacity_factor = 1.0

    def set_capacity(self, factor: float) -> None:
        """Clamp admission to ``factor`` x the healthy-cluster budget
        (0 < factor <= 1; 1.0 restores full capacity).  NaN and
        non-positive factors are rejected loudly — a NaN would otherwise
        poison every subsequent budget into ``min_admit`` floor values."""
        if not math.isfinite(factor):
            raise ValueError(f"capacity factor must be finite, got {factor}")
        if not 0.0 < factor <= 1.0:
            raise ValueError(f"capacity factor must be in (0, 1], got {factor}")
        self.capacity_factor = float(factor)

    # ---- budget ------------------------------------------------------------
    def budgets(
        self,
        plan: SharesSkewPlan | None,
        concentration: float = 1.0,
    ) -> dict[str, int]:
        """Per-relation row budgets for the next batch.  ``concentration``
        is the sketch's predicted worst per-reducer load ÷ q for the
        current inflow (>= 1 tightens the budget): a hot unpinned value
        concentrates arrivals, so fewer rows fit the same capacity."""
        if not self.policy.enabled or plan is None:
            return {r.name: np.iinfo(np.int64).max for r in self.query.relations}
        k = max(1, plan.total_reducers)
        out = {}
        for rel in self.query.relations:
            w = replication_width(plan, rel.name)
            budget = self.policy.headroom * self.q * k / w
            budget /= max(1.0, float(concentration))
            budget *= self.capacity_factor
            out[rel.name] = max(self.policy.min_admit, int(budget))
        return out

    # ---- admission ---------------------------------------------------------
    def admit(
        self,
        batch: Mapping[str, np.ndarray],
        plan: SharesSkewPlan | None,
        concentration: float = 1.0,
    ) -> tuple[dict[str, np.ndarray], AdmissionDecision]:
        """Split (backlog ++ batch) into admitted rows (FIFO, backlog
        first) and a new backlog; shed backlog overflow oldest-first.
        Returns (admitted rows per relation, exact accounting)."""
        budgets = self.budgets(plan, concentration)
        admitted_rows: dict[str, np.ndarray] = {}
        admitted_n, deferred_n, shed_n, budget_rep = {}, {}, {}, {}
        for rel in self.query.relations:
            nm = rel.name
            pending = np.concatenate(
                [self.backlog[nm], np.asarray(batch[nm]).reshape(-1, rel.arity)],
                axis=0,
            )
            b = budgets[nm]
            take = min(len(pending), b)
            admitted_rows[nm] = pending[:take]
            rest = pending[take:]
            over = max(0, len(rest) - self.policy.max_backlog_rows)
            if over:
                rest = rest[over:]  # shed oldest-first
            self.backlog[nm] = rest
            admitted_n[nm] = int(take)
            deferred_n[nm] = int(len(rest))
            shed_n[nm] = int(over)
            budget_rep[nm] = int(min(b, np.iinfo(np.int64).max))
        decision = AdmissionDecision(admitted_n, deferred_n, shed_n, budget_rep)
        self.total_deferred += decision.total_deferred
        self.total_shed += decision.total_shed
        return admitted_rows, decision

    # ---- checkpoint --------------------------------------------------------
    def state_dict(self) -> dict[str, np.ndarray]:
        out = {f"backlog/{nm}": arr for nm, arr in self.backlog.items()}
        out["totals"] = np.array(
            [self.total_deferred, self.total_shed], dtype=np.int64
        )
        out["capacity"] = np.array([self.capacity_factor], dtype=np.float64)
        return out

    def load_state_dict(self, state: Mapping[str, np.ndarray]) -> None:
        for nm in self.backlog:
            self.backlog[nm] = np.asarray(state[f"backlog/{nm}"])
        totals = np.asarray(state["totals"])
        self.total_deferred = int(totals[0])
        self.total_shed = int(totals[1])
        if "capacity" in state:  # absent in pre-recovery checkpoints
            self.capacity_factor = float(np.asarray(state["capacity"])[0])


# ---- multi-tenant fair share (DESIGN.md §9) --------------------------------
def weighted_fair_allocation(
    demands: Mapping[str, float],
    weights: Mapping[str, float],
    capacity: float,
) -> dict[str, float]:
    """Weighted max-min fair allocation (water-filling).

    Splits ``capacity`` (in the same units as ``demands`` — the engine uses
    predicted reducer arrivals, rows x replication width) across tenants:
    a tenant whose demand fits under its weighted share keeps ALL of it,
    and the freed surplus is re-divided among the still-hungry tenants by
    weight.  The classic invariants hold: no tenant gets more than its
    demand, the allocation is work-conserving (sum == min(capacity, total
    demand)), and when aggregate demand fits, allocation == demand for
    everyone — overload control is invisible until there is overload.
    """
    if not math.isfinite(capacity) or capacity < 0:
        raise ValueError(f"capacity must be finite and >= 0, got {capacity}")
    for t, w in weights.items():
        if not math.isfinite(w) or w <= 0:
            raise ValueError(f"tenant {t!r} weight must be finite > 0, got {w}")
    for t, d in demands.items():
        if not math.isfinite(d) or d < 0:
            raise ValueError(f"tenant {t!r} demand must be finite >= 0, got {d}")
    alloc = {t: 0.0 for t in demands}
    active = sorted(t for t in demands if demands[t] > 0)
    remaining = float(capacity)
    while active and remaining > 1e-12:
        wsum = sum(weights.get(t, 1.0) for t in active)
        share = {t: remaining * weights.get(t, 1.0) / wsum for t in active}
        satisfied = [t for t in active if demands[t] - alloc[t] <= share[t]]
        if not satisfied:
            for t in active:
                alloc[t] += share[t]
            break
        for t in satisfied:
            take = demands[t] - alloc[t]
            alloc[t] = demands[t]
            remaining -= take
        active = [t for t in active if t not in satisfied]
    return alloc


class FairShareController:
    """Aggregate overload control across tenants (DESIGN.md §9).

    Each batch, every tenant's *demand* is its offered rows weighted by the
    replication width of its live plan (the per-query communication budget
    of Beame-Koutris-Suciu: what the tenant will actually ship).  When the
    aggregate demand exceeds ``capacity`` predicted arrivals per batch, the
    weighted max-min allocation above decides who is trimmed; tenants under
    their fair share are never touched, so overload on one tenant cannot
    perturb a well-behaved neighbor's rows (the isolation contract the
    tenancy tests assert bit-for-bit).  Trimming is counted per tenant as
    ``overload_shed`` rows plus a ``backpressure`` event per trimmed batch
    — exact counters, same contract as ``AdmissionController``.

    ``capacity=None`` disables aggregate control (every tenant admitted in
    full; per-tenant ``AdmissionController``s still apply downstream).
    """

    def __init__(
        self,
        capacity: float | None,
        weights: Mapping[str, float],
    ):
        if capacity is not None and (
            not math.isfinite(capacity) or capacity <= 0
        ):
            raise ValueError(
                f"aggregate capacity must be finite and > 0, got {capacity}"
            )
        for t, w in weights.items():
            if not math.isfinite(w) or w <= 0:
                raise ValueError(
                    f"tenant {t!r} weight must be finite > 0, got {w}"
                )
        self.capacity = None if capacity is None else float(capacity)
        self.weights = {t: float(w) for t, w in weights.items()}
        self.overload_shed: dict[str, int] = {t: 0 for t in weights}
        self.backpressure: dict[str, int] = {t: 0 for t in weights}

    def fractions(self, demands: Mapping[str, float]) -> dict[str, float]:
        """Admitted fraction per tenant for one batch (1.0 = untrimmed)."""
        if self.capacity is None:
            return {t: 1.0 for t in demands}
        total = sum(demands.values())
        if total <= self.capacity:
            return {t: 1.0 for t in demands}
        alloc = weighted_fair_allocation(demands, self.weights, self.capacity)
        return {
            t: (alloc[t] / demands[t]) if demands[t] > 0 else 1.0
            for t in demands
        }

    def record_trim(self, tenant: str, rows_trimmed: int) -> None:
        if rows_trimmed > 0:
            self.overload_shed[tenant] = (
                self.overload_shed.get(tenant, 0) + int(rows_trimmed)
            )
            self.backpressure[tenant] = self.backpressure.get(tenant, 0) + 1

    # ---- checkpoint --------------------------------------------------------
    def state_dict(self) -> dict[str, np.ndarray]:
        names = sorted(self.weights)
        return {
            "shed": np.array(
                [self.overload_shed.get(t, 0) for t in names], np.int64
            ),
            "backpressure": np.array(
                [self.backpressure.get(t, 0) for t in names], np.int64
            ),
        }

    def load_state_dict(self, state: Mapping[str, np.ndarray]) -> None:
        names = sorted(self.weights)
        shed = np.asarray(state["shed"])
        bp = np.asarray(state["backpressure"])
        if shed.size != len(names) or bp.size != len(names):
            raise ValueError("fair-share checkpoint tenant count mismatch")
        self.overload_shed = {t: int(s) for t, s in zip(names, shed)}
        self.backpressure = {t: int(b) for t, b in zip(names, bp)}
