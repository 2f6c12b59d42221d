"""SharesSkew planner (paper §4 + §5 stages 1-3).

Produces a ``SharesSkewPlan``: the list of surviving residual joins, each
with relevant sizes, a reducer budget k_J chosen so the expected
per-reducer load is <= q, integer shares (the reducer grid), and a global
reducer-id block.  The plan is consumed by ``repro_torch.mapreduce.executor``
(stage 4: tuple distribution).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import numpy as np

from .cost import CostExpression
from .dominance import share_attributes
from .residual import (
    Combination,
    ORDINARY,
    detect_heavy_hitters,
    enumerate_combinations,
    prune_by_subsumption,
    relevant_sizes,
)
from .schema import JoinQuery, RelationSchema
from .shares import (
    SharesSolution,
    reproject_solution,
    solve_k_for_capacity,
    solve_shares,
)


@dataclasses.dataclass(frozen=True)
class ResidualPlan:
    """One residual join: its data slice, reducer grid and share solution."""

    combo: Combination
    sizes: dict[str, int]
    k_budget: int  # k chosen by the capacity rule
    solution: SharesSolution
    reducer_offset: int  # global reducer ids [offset, offset + num_reducers)

    @property
    def grid_attrs(self) -> tuple[str, ...]:
        """Attributes with integer share > 1, in query attribute order
        (the dimensions of this residual's reducer grid)."""
        return tuple(
            a
            for a in self.solution.cost_expr.query.attributes
            if self.solution.int_shares.get(a, 1) > 1
        )

    @property
    def grid_dims(self) -> tuple[int, ...]:
        return tuple(self.solution.int_shares[a] for a in self.grid_attrs)

    @property
    def num_reducers(self) -> int:
        return int(math.prod(self.grid_dims)) if self.grid_dims else 1

    def int_replication(self, rel_attrs: tuple[str, ...]) -> int:
        """How many reducers each tuple of a relation with ``rel_attrs`` is
        sent to under the integer shares (the executor's exact model)."""
        return math.prod(
            self.solution.int_shares[a]
            for a in self.grid_attrs
            if a not in rel_attrs
        )

    def describe(self) -> str:
        dims = ", ".join(f"{a}:{d}" for a, d in zip(self.grid_attrs, self.grid_dims))
        return (
            f"residual {self.combo} sizes={self.sizes} k={self.num_reducers}"
            f" grid=[{dims}] cost={self.solution.int_cost:.0f}"
        )


@dataclasses.dataclass(frozen=True)
class SharesSkewPlan:
    query: JoinQuery
    q: float  # reducer capacity
    hh_values: dict[str, np.ndarray]
    residuals: tuple[ResidualPlan, ...]

    @property
    def total_reducers(self) -> int:
        return sum(r.num_reducers for r in self.residuals)

    @property
    def predicted_cost(self) -> float:
        """Total tuples shipped mapper->reducer (integer-share model)."""
        return sum(r.solution.int_cost for r in self.residuals)

    def describe(self) -> str:
        lines = [
            f"SharesSkew plan for {self.query}  (q={self.q:g})",
            f"  heavy hitters: "
            + (
                ", ".join(f"{a}:{v.tolist()}" for a, v in self.hh_values.items())
                or "none"
            ),
        ]
        lines += ["  " + r.describe() for r in self.residuals]
        lines.append(
            f"  total reducers={self.total_reducers} predicted_cost={self.predicted_cost:.0f}"
        )
        return "\n".join(lines)


def plan_shares_skew(
    query: JoinQuery,
    data: Mapping[str, np.ndarray],
    q: float,
    hh_threshold: float | None = None,
    max_hh_per_attr: int = 8,
    k_max: int = 1 << 22,
    prune: bool = True,
) -> SharesSkewPlan:
    """Stages 1-3 of SharesSkew (§5.2): detect HHs, prune subsumed values,
    enumerate residual joins, and solve each residual's shares under the
    per-reducer capacity q."""
    threshold = float(hh_threshold if hh_threshold is not None else q)
    candidates = share_attributes(query)  # §4.1: HHs only for non-dominated
    hh = detect_heavy_hitters(query, data, threshold, candidates, max_hh_per_attr)
    if prune and hh:
        hh, _, _ = prune_by_subsumption(query, data, hh, q, k_max)

    residuals: list[ResidualPlan] = []
    offset = 0
    for combo in enumerate_combinations(hh):
        sizes = relevant_sizes(query, data, combo, hh)
        if any(s == 0 for s in sizes.values()):
            continue  # empty residual join -> contributes no output
        pinned = frozenset(combo.pinned)
        k, sol = solve_k_for_capacity(query, sizes, q, pinned, k_max)
        rp = ResidualPlan(combo, sizes, k, sol, offset)
        residuals.append(rp)
        offset += rp.num_reducers
    return SharesSkewPlan(query, q, hh, tuple(residuals))


def plan_with_hh(
    query: JoinQuery,
    data: Mapping[str, np.ndarray],
    q: float,
    hh_values: Mapping[str, np.ndarray],
    max_hh_per_attr: int = 8,
    k_max: int = 1 << 22,
    max_combos: int = 1024,
) -> SharesSkewPlan:
    """SharesSkew stages 2-3 with an externally supplied heavy-hitter set.

    The batch planner (``plan_shares_skew``) detects HHs by an exact scan of
    ``data``; the streaming engine instead tracks HH candidates across
    micro-batches with mergeable sketches and plans
    each epoch from that live set — ``data`` here is only the current
    micro-batch, used for residual relevant sizes and share solving.
    Candidate attrs are filtered to non-dominated share attributes and capped
    at ``max_hh_per_attr`` (sketch order is assumed count-descending).

    Unlike ``plan_shares_skew``, combinations empty on ``data`` are KEPT
    (with a 1-reducer grid): the plan outlives the batch it was solved on,
    and a residual with no relevant tuples today may receive tuples from a
    later micro-batch — dropping it would silently lose join results.
    """
    candidates = share_attributes(query)
    hh: dict[str, np.ndarray] = {}
    for attr, vals in hh_values.items():
        vals = np.asarray(vals, dtype=np.int64)
        if attr in candidates and vals.size:
            hh[attr] = vals[:max_hh_per_attr]
    # the stream must never die mid-ingest on a rich HH set: trim the
    # lowest-ranked candidates (sketch order is rate-descending) until the
    # combination space fits, rather than raising like the batch planner
    while math.prod(1 + len(v) for v in hh.values()) > max_combos:
        widest = max(hh, key=lambda a: len(hh[a]))
        if len(hh[widest]) <= 1:
            hh.pop(widest)
        else:
            hh[widest] = hh[widest][:-1]

    residuals: list[ResidualPlan] = []
    offset = 0
    for combo in enumerate_combinations(hh, max_combos):
        sizes = relevant_sizes(query, data, combo, hh)
        pinned = frozenset(combo.pinned)
        k, sol = solve_k_for_capacity(query, sizes, q, pinned, k_max)
        rp = ResidualPlan(combo, sizes, k, sol, offset)
        residuals.append(rp)
        offset += rp.num_reducers
    return SharesSkewPlan(query, q, hh, tuple(residuals))


def repair_plan(plan: SharesSkewPlan, k_max: int) -> SharesSkewPlan:
    """Re-project an incumbent plan onto a smaller reducer budget — the
    degraded-mode half of reducer-loss recovery (DESIGN.md §5).

    A replan-from-scratch (``plan_with_hh``) after host loss would re-detect
    HHs and re-enumerate combinations, moving HH values between residuals —
    and every moved combination drags its carried reducer state across the
    cluster.  Repair instead keeps the HH set and the combination list
    *identical* (zero HH-combination movement) and only shrinks each
    residual's grid: budgets scale proportionally (``k_i' = k_i * k_max /
    K``, floors summing <= k_max), and each residual's shares are
    re-projected onto its new budget via the closed-form scaling fast path
    (``reproject_solution`` — exact for the paper's structured joins, the
    minimum-movement feasible projection otherwise; no SLSQP on the
    recovery path).  Reducer-id blocks are re-packed contiguously.

    Raises ``ValueError`` when ``k_max`` cannot host one reducer per
    residual — the caller (the engine) surfaces that as recovery
    exhaustion, an explicit error rather than a silently dropped residual.
    """
    n_res = len(plan.residuals)
    if k_max < n_res:
        raise ValueError(
            f"cannot repair plan: budget {k_max} < {n_res} residuals "
            "(every combination needs at least one reducer)"
        )
    k_old = plan.total_reducers
    if k_max >= k_old:
        return plan
    budgets = [
        max(1, (r.num_reducers * k_max) // k_old) for r in plan.residuals
    ]
    # the max(1, .) floors can overshoot k_max when many residuals round up
    # from zero; shave the largest budgets until the total fits
    while sum(budgets) > k_max:
        i = max(range(n_res), key=budgets.__getitem__)
        if budgets[i] <= 1:  # pragma: no cover - guarded by k_max >= n_res
            raise ValueError("cannot repair plan: budget exhausted")
        budgets[i] -= 1
    residuals: list[ResidualPlan] = []
    offset = 0
    for r, k_i in zip(plan.residuals, budgets):
        sol = reproject_solution(r.solution, float(k_i))
        if sol.num_reducers > k_i:  # pragma: no cover - rounding guarantees <=
            sol = solve_shares(
                plan.query, r.sizes, k_i, frozenset(r.combo.pinned)
            )
        rp = ResidualPlan(r.combo, r.sizes, k_i, sol, offset)
        residuals.append(rp)
        offset += rp.num_reducers
    return SharesSkewPlan(plan.query, plan.q, plan.hh_values, tuple(residuals))


def plan_plain_shares(
    query: JoinQuery,
    data: Mapping[str, np.ndarray],
    k: int | None = None,
    q: float | None = None,
) -> SharesSkewPlan:
    """Baseline: the original Shares algorithm — a single residual join, no
    heavy-hitter handling (skew lands wherever the hash sends it).
    Give either a fixed reducer budget ``k`` or a capacity ``q``."""
    sizes = {r.name: int(np.asarray(data[r.name]).shape[0]) for r in query.relations}
    if (k is None) == (q is None):
        raise ValueError("pass exactly one of k / q")
    if k is not None:
        sol = solve_shares(query, sizes, k)
        k_budget = int(k)
        cap = sol.cost / max(1, k)
    else:
        k_budget, sol = solve_k_for_capacity(query, sizes, q)
        cap = float(q)
    combo = Combination.of({})
    rp = ResidualPlan(combo, sizes, k_budget, sol, 0)
    return SharesSkewPlan(query, cap, {}, (rp,))


def plan_to_arrays(plan: SharesSkewPlan) -> dict:
    """A plan's content as plain Python and numpy values — the keyword
    arguments of ``plan_from_arrays``.  Reads attributes only, so it also
    accepts any plan object with the same fields."""
    return {
        "relations": [(r.name, tuple(r.attrs)) for r in plan.query.relations],
        "q": float(plan.q),
        "hh_values": {
            a: np.asarray(v, dtype=np.int64) for a, v in plan.hh_values.items()
        },
        "residuals": [
            {
                "types": [(a, None if v is None else int(v)) for a, v in r.combo.types],
                "sizes": {n: int(s) for n, s in r.sizes.items()},
                "k_budget": int(r.k_budget),
                "shares": {a: float(x) for a, x in r.solution.shares.items()},
                "int_shares": {a: int(x) for a, x in r.solution.int_shares.items()},
                "cost": float(r.solution.cost),
                "int_cost": float(r.solution.int_cost),
                "reducer_offset": int(r.reducer_offset),
            }
            for r in plan.residuals
        ],
    }


def plan_from_arrays(
    relations,
    q: float,
    hh_values: Mapping[str, np.ndarray],
    residuals,
) -> SharesSkewPlan:
    """Rebuild a ``SharesSkewPlan`` from its content (``plan_to_arrays``).

    ``relations`` is a sequence of (name, attrs); each residual is a mapping
    with ``types`` (attr, pinned value or None), ``sizes``, ``k_budget``,
    continuous ``shares``, ``int_shares``, ``cost``, ``int_cost`` and
    ``reducer_offset``.  The cost expression is re-derived from the query,
    the sizes and the combination's pinned attributes, as the planner
    derives it; the solver budget is ``k_budget``, as in every batch plan.
    """
    query = JoinQuery(tuple(RelationSchema(n, tuple(a)) for n, a in relations))
    out = []
    for r in residuals:
        combo = Combination(tuple((a, v) for a, v in r["types"]))
        sizes = {n: int(s) for n, s in r["sizes"].items()}
        expr = CostExpression.build(
            query, sizes, share_attributes(query, frozenset(combo.pinned))
        )
        sol = SharesSolution(
            cost_expr=expr,
            k=float(r["k_budget"]),
            shares={a: float(x) for a, x in r["shares"].items()},
            int_shares={a: int(x) for a, x in r["int_shares"].items()},
            cost=float(r["cost"]),
            int_cost=float(r["int_cost"]),
        )
        out.append(
            ResidualPlan(combo, sizes, int(r["k_budget"]), sol, int(r["reducer_offset"]))
        )
    hh = {a: np.asarray(v, dtype=np.int64) for a, v in hh_values.items()}
    return SharesSkewPlan(query, float(q), hh, tuple(out))
