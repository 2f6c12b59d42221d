"""Share computation (paper §3, §5 stage 2-3).

Minimize   cost(x) = sum_j r_j * prod_{a in repl_j} x_a
subject to prod_i x_i = k,  x_i >= 1.

In log-space (y = log x) the objective is a sum of exponentials of affine
functions and the constraint is linear, i.e. a convex (geometric) program.
We solve it with projected SLSQP, seeded by the Lagrangean balance
condition; structured joins (2-way, chains, symmetric) additionally have
closed forms in ``closed_forms.py`` that tests cross-check against this
solver.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Mapping

import numpy as np
from scipy import optimize

from .cost import CostExpression
from .dominance import share_attributes
from .schema import JoinQuery


@dataclasses.dataclass(frozen=True)
class SharesSolution:
    """Continuous + integer share assignment for one (residual) join."""

    cost_expr: CostExpression
    k: float  # reducer budget given to the solver
    shares: dict[str, float]  # continuous optimum (dominated attrs -> 1.0)
    int_shares: dict[str, int]  # rounded, prod <= k
    cost: float  # continuous optimal communication cost
    int_cost: float  # cost at the integer shares

    @property
    def num_reducers(self) -> int:
        return math.prod(self.int_shares.values()) if self.int_shares else 1

    def per_relation_cost(self) -> dict[str, float]:
        return self.cost_expr.per_relation({**self.shares})

    def replication(self, rel_name: str) -> float:
        return self.cost_expr.replication_of(rel_name, self.shares)


def _solve_log_space(expr: CostExpression, k: float) -> dict[str, float]:
    """Continuous optimum of the geometric program, shares as floats >= 1."""
    attrs = expr.share_attrs
    n = len(attrs)
    if n == 0:
        return {}
    log_k = math.log(k)
    if n == 1:
        return {attrs[0]: float(k)}

    idx = {a: i for i, a in enumerate(attrs)}
    # term j: coeff r_j, mask over y
    masks = []
    log_sizes = []
    scale = max(expr.sizes) or 1.0
    for size, repl in zip(expr.sizes, expr.repl_attrs):
        if size <= 0:
            continue
        m = np.zeros(n)
        for a in repl:
            m[idx[a]] = 1.0
        masks.append(m)
        log_sizes.append(math.log(size / scale))
    if not masks:
        # all relevant sizes zero: any feasible point
        y = np.full(n, log_k / n)
        return {a: float(math.exp(v)) for a, v in zip(attrs, y)}
    M = np.stack(masks)  # [T, n]
    ls = np.array(log_sizes)  # [T]

    def f(y: np.ndarray) -> float:
        return float(np.sum(np.exp(ls + M @ y)))

    def grad(y: np.ndarray) -> np.ndarray:
        t = np.exp(ls + M @ y)
        return M.T @ t

    cons = {
        "type": "eq",
        "fun": lambda y: np.sum(y) - log_k,
        "jac": lambda y: np.ones(n),
    }
    bounds = [(0.0, log_k)] * n
    y0 = np.full(n, log_k / n)
    best = None
    for start in (y0, np.zeros(n) + 1e-3, np.linspace(0.0, 1.0, n) * log_k / max(1, n)):
        start = np.clip(start, 0, log_k)
        # re-project start onto the constraint
        start = start + (log_k - start.sum()) / n
        start = np.clip(start, 0, log_k)
        if abs(start.sum() - log_k) > 1e-9:
            # clip broke the constraint (some coords pinned); spread remainder
            free = (start > 0) & (start < log_k)
            if free.any():
                start[free] += (log_k - start.sum()) / free.sum()
        res = optimize.minimize(
            f, start, jac=grad, bounds=bounds, constraints=[cons],
            method="SLSQP", options={"maxiter": 500, "ftol": 1e-12},
        )
        if res.success and (best is None or res.fun < best.fun):
            best = res
    if best is None:  # pragma: no cover - SLSQP failure fallback
        y = y0
    else:
        y = best.x
    return {a: float(math.exp(v)) for a, v in zip(attrs, y)}


def _round_shares(expr: CostExpression, cont: Mapping[str, float], k: float) -> dict[str, int]:
    """Round continuous shares to integers with product <= k, minimizing cost.

    Enumerates floor/ceil per attribute when feasible; falls back to floors.
    """
    attrs = expr.share_attrs
    if not attrs:
        return {}
    floors = {a: max(1, int(math.floor(cont[a] + 1e-9))) for a in attrs}
    if len(attrs) <= 12:
        best: tuple[float, dict[str, int]] | None = None
        choices = [(a, sorted({floors[a], max(1, int(math.ceil(cont[a] - 1e-9)))})) for a in attrs]
        for combo in itertools.product(*(c for _, c in choices)):
            cand = dict(zip([a for a, _ in choices], combo))
            if math.prod(cand.values()) > k + 1e-9:
                continue
            c = expr.evaluate({**cand})
            if best is None or c < best[0]:
                best = (c, cand)
        if best is not None:
            return best[1]
    return floors


def solve_shares(
    query: JoinQuery,
    sizes: Mapping[str, float],
    k: float,
    fixed_to_one: frozenset[str] | set[str] = frozenset(),
) -> SharesSolution:
    """Full pipeline: pin HH attrs to 1, apply dominance, solve, round.

    ``sizes`` are the *relevant* relation sizes for the residual join at
    hand (paper stage 3).  Returns shares for every attribute of the query
    (pinned/dominated ones mapped to 1).
    """
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    share_attrs = share_attributes(query, fixed_to_one)
    expr = CostExpression.build(query, sizes, share_attrs)
    cont = _solve_log_space(expr, float(k))
    ints = _round_shares(expr, cont, float(k))
    all_attrs = query.attributes
    shares = {a: cont.get(a, 1.0) for a in all_attrs}
    int_shares = {a: ints.get(a, 1) for a in all_attrs}
    return SharesSolution(
        cost_expr=expr,
        k=float(k),
        shares=shares,
        int_shares=int_shares,
        cost=expr.evaluate(shares),
        int_cost=expr.evaluate({a: float(v) for a, v in int_shares.items()}),
    )


def reproject_solution(sol: SharesSolution, k_new: float) -> SharesSolution:
    """Re-project an incumbent share assignment onto a new reducer budget
    without re-running the solver (the plan-repair fast path, DESIGN.md §5).

    In log-space the GP constraint is sum(y) = log k, so shrinking the
    budget slides the optimum along the constraint normal: every active
    share scales by the same factor ``(k'/k)^(1/m)`` (m = #share attrs).
    For the paper's structured joins (2-way, symmetric, triangle) the
    closed forms in ``closed_forms.py`` are exact power laws in k, so this
    scaling IS the new optimum; for general residuals it is the
    minimum-movement feasible projection of the incumbent — which is what
    plan repair wants: the repaired grid stays recognizably the old grid,
    so reducer-state migration is minimized.  A share the scaling would
    push below the x >= 1 boundary is clamped there and its budget
    redistributed over the still-free shares (water-filling), so the
    projected product never exceeds k'.
    """
    if k_new < 1:
        raise ValueError(f"k must be >= 1, got {k_new}")
    expr = sol.cost_expr
    attrs = expr.share_attrs
    if not attrs or k_new >= sol.k:
        return sol if k_new == sol.k else dataclasses.replace(sol, k=float(k_new))
    cont = {a: 1.0 for a in attrs}
    free = {a: sol.shares[a] for a in attrs if sol.shares[a] > 1.0}
    while free:
        f = min(1.0, (k_new / math.prod(free.values())) ** (1.0 / len(free)))
        scaled = {a: v * f for a, v in free.items()}
        clamped = [a for a, v in scaled.items() if v < 1.0]
        if not clamped:
            cont.update(scaled)
            break
        for a in clamped:  # pinned at the boundary; contributes 1 to prod
            free.pop(a)
    ints = _round_shares(expr, cont, float(k_new))
    all_attrs = expr.query.attributes
    shares = {a: cont.get(a, 1.0) for a in all_attrs}
    int_shares = {a: ints.get(a, 1) for a in all_attrs}
    return SharesSolution(
        cost_expr=expr,
        k=float(k_new),
        shares=shares,
        int_shares=int_shares,
        cost=expr.evaluate(shares),
        int_cost=expr.evaluate({a: float(v) for a, v in int_shares.items()}),
    )


def solve_k_for_capacity(
    query: JoinQuery,
    sizes: Mapping[str, float],
    q: float,
    fixed_to_one: frozenset[str] | set[str] = frozenset(),
    k_max: int = 1 << 22,
) -> tuple[int, SharesSolution]:
    """Paper §4.2: pick the smallest k whose expected per-reducer load
    cost*(k)/k is <= q.  Expected load is monotone nonincreasing in k, so we
    binary search.  Returns (k, solution at k)."""
    if q <= 0:
        raise ValueError("q must be positive")

    def load(k: int) -> float:
        sol = solve_shares(query, sizes, k, fixed_to_one)
        return sol.cost / k

    total = sum(float(sizes[r.name]) for r in query.relations)
    if total <= q:
        return 1, solve_shares(query, sizes, 1, fixed_to_one)
    lo, hi = 1, 2
    while hi < k_max and load(hi) > q:
        lo, hi = hi, hi * 2
    hi = min(hi, k_max)
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        if load(mid) > q:
            lo = mid
        else:
            hi = mid
    return hi, solve_shares(query, sizes, hi, fixed_to_one)
