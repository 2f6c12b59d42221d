"""Drift detection: when is the running plan stale enough to replan?
(DESIGN.md §6.)

A SharesSkew plan is optimal for the skew profile it was solved against.
Under drift two things go wrong, and each has a cheap per-batch check
against the live sketch — no replanning required to *decide*:

  * **Overload drift.**  A value that became heavy after planning is not
    pinned, so the ordinary residual hashes all its tuples to a single
    coordinate along its attribute: expected per-reducer load
    ``rate * x_attr / k`` (the ``k / x_attr`` reducers sharing that hash
    coordinate split the arrivals).  When any candidate's predicted load
    exceeds ``load_factor * q`` the plan has lost the paper's capacity
    guarantee.  Conversely a pinned value that faded keeps paying its
    residual's replication for nothing — wasted-replication drift.
  * **Communication drift.**  Evaluating the running plan's cost model
    (``CostExpression`` with the plan's integer shares) on the current
    batch's relevant sizes predicts this batch's shuffle exactly
    (``predicted_comm`` semantics, fresh sizes).  When that exceeds
    ``comm_factor`` x the per-batch volume the plan was installed against,
    the size profile has shifted.

Replanning is then one ``plan_with_hh`` call from the live sketch — the
expensive exact preliminary scan of the batch algorithm never runs.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

from repro_torch.core.planner import SharesSkewPlan
from repro_torch.core.residual import relevant_sizes
from repro_torch.core.schema import JoinQuery

from .sketch import HHSnapshot


@dataclasses.dataclass(frozen=True)
class DriftDecision:
    replan: bool
    reason: str  # "" when not replanning
    predicted_comm: float  # running plan's comm on the current batch
    baseline_comm: float  # per-batch comm at install time
    worst_load: float  # worst predicted per-reducer load (tuples)
    worst_value: int | None  # the value predicting that load
    # machine-readable trigger (DESIGN.md §10): which check fired and the
    # observed-vs-threshold pair behind it.  "" / 0 / 0 when no check fired;
    # kept even when cooldown suppresses the replan, so telemetry can tell
    # "nothing drifted" apart from "drifted but still cooling down".
    trigger: str = ""  # "overload" | "comm" | "faded_pin" | ""
    observed: float = 0.0  # the quantity that crossed
    threshold: float = 0.0  # the value it crossed


def plan_comm_on_batch(
    plan: SharesSkewPlan, query: JoinQuery, data: Mapping[str, np.ndarray]
) -> float:
    """The shuffle volume the running plan will produce on ``data``:
    per residual, relevant size x integer-share replication (the
    ``mapreduce.executor.predicted_comm`` model with fresh sizes)."""
    total = 0.0
    for res in plan.residuals:
        sizes = relevant_sizes(query, data, res.combo, plan.hh_values)
        for rel in query.relations:
            total += sizes[rel.name] * res.int_replication(rel.attrs)
    return total


def predicted_loads(
    plan: SharesSkewPlan, snapshot: Mapping[str, HHSnapshot]
) -> list[tuple[int, str, float]]:
    """(value, attr, predicted per-reducer load) for each live HH candidate.

    Pinned values spread over their residual's whole grid (load rate/k);
    unpinned values hash to one coordinate of the residual that absorbs
    them, concentrating on k/x_attr reducers (load rate*x/k).
    """
    out: list[tuple[int, str, float]] = []
    ordinary = next((r for r in plan.residuals if not r.combo.pinned), None)
    for attr, snap in snapshot.items():
        pinned_vals = set(np.asarray(plan.hh_values.get(attr, ())).tolist())
        for v, rate in zip(snap.values.tolist(), snap.rates.tolist()):
            if v in pinned_vals:
                res = next(
                    (r for r in plan.residuals if r.combo.pinned.get(attr) == v),
                    None,
                )
                if res is not None:
                    out.append((v, attr, rate / max(1, res.num_reducers)))
            elif ordinary is not None:
                x = ordinary.solution.int_shares.get(attr, 1)
                k = max(1, ordinary.num_reducers)
                out.append((v, attr, rate * x / k))
    return out


class DriftMonitor:
    """Per-batch staleness check for the running plan."""

    def __init__(
        self,
        q: float,
        comm_factor: float = 1.5,
        load_factor: float = 3.0,
        fade_factor: float = 0.25,
        cooldown: int = 1,
    ):
        self.q = float(q)
        self.comm_factor = float(comm_factor)
        self.load_factor = float(load_factor)
        self.fade_factor = float(fade_factor)
        self.cooldown = int(cooldown)
        self._baseline_comm: float = 0.0
        self._since_replan: int = 0

    def install(
        self, plan: SharesSkewPlan, query: JoinQuery, data: Mapping[str, np.ndarray]
    ) -> None:
        """Record the per-batch volume the fresh plan predicts for the batch
        it was solved against — the reference point for comm drift."""
        self._baseline_comm = plan_comm_on_batch(plan, query, data)
        self._since_replan = 0

    def check(
        self,
        plan: SharesSkewPlan,
        query: JoinQuery,
        data: Mapping[str, np.ndarray],
        snapshot: Mapping[str, HHSnapshot],
        pinned_rates: Mapping[tuple[str, int], float] | None = None,
    ) -> DriftDecision:
        """``pinned_rates`` maps (attr, pinned value) -> live per-batch rate;
        when given, a pinned value whose rate faded below ``fade_factor * q``
        triggers wasted-replication drift (its residual keeps replicating
        the other relations for a value the stream has moved past).  The
        hysteresis gap between the pin threshold (~q) and ``fade_factor * q``
        prevents replan thrash for values hovering at the threshold."""
        comm = plan_comm_on_batch(plan, query, data)
        loads = predicted_loads(plan, snapshot)
        worst_value, _, worst_load = max(
            loads, key=lambda t: t[2], default=(None, "", 0.0)
        )
        self._since_replan += 1
        reason = ""
        trigger = ""
        observed = threshold = 0.0
        faded = [
            (a, v, r)
            for (a, v), r in (pinned_rates or {}).items()
            if r < self.fade_factor * self.q
        ]
        if worst_load > self.load_factor * self.q:
            trigger = "overload"
            observed, threshold = worst_load, self.load_factor * self.q
            reason = (
                f"overload: value {worst_value} predicts per-reducer load "
                f"{worst_load:.0f} > {self.load_factor:g}*q"
            )
        elif comm > self.comm_factor * self._baseline_comm and comm > 0:
            # a zero baseline (plan installed against an empty/near-empty
            # batch) must not disable the trigger: any real traffic on such
            # a degenerate plan is comm drift
            trigger = "comm"
            observed, threshold = comm, self.comm_factor * self._baseline_comm
            reason = (
                f"comm: predicted {comm:.0f} > {self.comm_factor:g}x "
                f"install baseline {self._baseline_comm:.0f}"
            )
        elif faded:
            a, v, r = faded[0]
            trigger = "faded_pin"
            observed, threshold = r, self.fade_factor * self.q
            reason = (
                f"faded pin: {a}={v} rate {r:.1f} < {self.fade_factor:g}*q; "
                "its residual replicates for a value the stream moved past"
            )
        replan = bool(reason) and self._since_replan > self.cooldown
        return DriftDecision(
            replan=replan,
            reason=reason if replan else "",
            predicted_comm=comm,
            baseline_comm=self._baseline_comm,
            worst_load=worst_load,
            worst_value=worst_value,
            trigger=trigger,
            observed=observed,
            threshold=threshold,
        )

    # ---- checkpoint (DESIGN.md §8) -----------------------------------------
    def state_dict(self) -> dict[str, np.ndarray]:
        """The two mutables that make drift decisions history-dependent:
        the install-time comm baseline and the cooldown counter.  Restoring
        them keeps post-restore replan decisions bit-identical to an
        uninterrupted run."""
        return {
            "scalars": np.array(
                [self._baseline_comm, float(self._since_replan)], np.float64
            )
        }

    def load_state_dict(self, state: dict[str, np.ndarray]) -> None:
        scalars = np.asarray(state["scalars"])
        self._baseline_comm = float(scalars[0])
        self._since_replan = int(scalars[1])
