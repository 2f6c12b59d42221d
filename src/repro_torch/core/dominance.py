"""Dominance rule (paper §3.1).

An attribute A is *dominated* by attribute B if B appears in every relation
in which A appears (and B != A).  A dominated attribute gets share 1 in the
optimal solution, so it is removed from the cost expression before solving.

Ties (A and B appear in exactly the same relation set) are broken by
first-appearance order so exactly one of them survives.  Attributes fixed to
share 1 by the caller (e.g. heavy-hitter attributes in a residual join) are
treated as absent when computing dominance — matching the paper's stage 3,
where dominance is applied to the *residual* cost expression.
"""
from __future__ import annotations

from .schema import JoinQuery


def dominated_attributes(
    query: JoinQuery,
    fixed_to_one: frozenset[str] | set[str] = frozenset(),
) -> frozenset[str]:
    """Return the set of attributes whose share is forced to 1 by dominance.

    ``fixed_to_one`` are attributes already pinned to share 1 (heavy hitters
    in the current residual join); they cannot dominate others and are not
    re-reported.
    """
    occ = query.occurrence_sets()
    attrs = [a for a in query.attributes if a not in fixed_to_one]
    order = {a: i for i, a in enumerate(query.attributes)}
    dominated: set[str] = set()
    for a in attrs:
        for b in attrs:
            if a == b or b in dominated:
                continue
            if occ[a] <= occ[b]:
                if occ[a] == occ[b]:
                    # tie: the earlier-declared attribute survives
                    if order[b] < order[a]:
                        dominated.add(a)
                        break
                else:
                    dominated.add(a)
                    break
    return frozenset(dominated)


def share_attributes(
    query: JoinQuery,
    fixed_to_one: frozenset[str] | set[str] = frozenset(),
) -> tuple[str, ...]:
    """Attributes that receive a (possibly >1) share after pinning HH
    attributes to 1 and applying dominance."""
    dom = dominated_attributes(query, fixed_to_one)
    return tuple(
        a for a in query.attributes if a not in dom and a not in fixed_to_one
    )
