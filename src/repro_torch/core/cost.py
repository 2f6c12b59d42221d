"""Communication-cost expressions for the Shares family (paper §3, §5).

The generic cost of distributing relations to a grid of reducers with share
``x_i`` for attribute ``i`` is

    cost(x) = sum_j  r_j * prod_{i not in attrs(R_j)} x_i

(each tuple of R_j is replicated once per grid cell along the dimensions of
the attributes it does not contain).  Attributes with share 1 drop out.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

from .schema import JoinQuery


@dataclasses.dataclass(frozen=True)
class CostExpression:
    """cost(x) = sum_j  size_j * prod_{a in repl_attrs_j} x_a .

    ``share_attrs`` is the ordered tuple of attributes that carry a share
    variable; every other attribute has share 1 and is omitted.
    """

    query: JoinQuery
    share_attrs: tuple[str, ...]
    sizes: tuple[float, ...]  # relevant size of each relation, query order
    repl_attrs: tuple[tuple[str, ...], ...]  # per relation: share attrs it lacks

    @classmethod
    def build(
        cls,
        query: JoinQuery,
        sizes: Mapping[str, float] | Sequence[float],
        share_attrs: Sequence[str],
    ) -> "CostExpression":
        if isinstance(sizes, Mapping):
            size_tuple = tuple(float(sizes[r.name]) for r in query.relations)
        else:
            size_tuple = tuple(float(s) for s in sizes)
        if len(size_tuple) != len(query.relations):
            raise ValueError("one size per relation required")
        share_attrs = tuple(share_attrs)
        repl = tuple(
            tuple(a for a in share_attrs if a not in r.attrs)
            for r in query.relations
        )
        return cls(query, share_attrs, size_tuple, repl)

    # ---- evaluation --------------------------------------------------------
    def evaluate(self, shares: Mapping[str, float]) -> float:
        total = 0.0
        for size, attrs in zip(self.sizes, self.repl_attrs):
            total += size * math.prod(shares[a] for a in attrs)
        return total

    def per_relation(self, shares: Mapping[str, float]) -> dict[str, float]:
        """Communication contributed by each relation (tuples shipped)."""
        out = {}
        for rel, size, attrs in zip(self.query.relations, self.sizes, self.repl_attrs):
            out[rel.name] = size * math.prod(shares[a] for a in attrs)
        return out

    def replication_of(self, rel_name: str, shares: Mapping[str, float]) -> float:
        """How many reducers each tuple of ``rel_name`` is sent to."""
        i = [r.name for r in self.query.relations].index(rel_name)
        return math.prod(shares[a] for a in self.repl_attrs[i])

    def num_reducers(self, shares: Mapping[str, float]) -> float:
        return math.prod(shares[a] for a in self.share_attrs)

    def __str__(self) -> str:
        terms = []
        for rel, attrs in zip(self.query.relations, self.repl_attrs):
            prod = "".join(f"·x_{a}" for a in attrs)
            terms.append(f"{rel.name.lower()}{prod}")
        return " + ".join(terms)
