"""Join-query schema / hypergraph definitions for SharesSkew.

A multiway natural (equi-)join is a hypergraph: vertices are attributes,
hyperedges are relations. This module is pure metadata — no tensors, no data.
Relations carry *sizes* separately (they change per residual join).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class RelationSchema:
    """A named relation with an ordered attribute tuple, e.g. R(A, B)."""

    name: str
    attrs: tuple[str, ...]

    def __post_init__(self) -> None:
        if len(set(self.attrs)) != len(self.attrs):
            raise ValueError(f"duplicate attribute in {self.name}: {self.attrs}")

    def __contains__(self, attr: str) -> bool:
        return attr in self.attrs

    @property
    def arity(self) -> int:
        return len(self.attrs)

    def index_of(self, attr: str) -> int:
        return self.attrs.index(attr)

    def __str__(self) -> str:  # R(A,B)
        return f"{self.name}({','.join(self.attrs)})"


@dataclasses.dataclass(frozen=True)
class JoinQuery:
    """A multiway natural join R_1 ⋈ R_2 ⋈ ... ⋈ R_n."""

    relations: tuple[RelationSchema, ...]

    def __post_init__(self) -> None:
        names = [r.name for r in self.relations]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate relation names: {names}")

    # ---- hypergraph views -------------------------------------------------
    @property
    def attributes(self) -> tuple[str, ...]:
        """All attributes, in first-appearance order."""
        seen: dict[str, None] = {}
        for r in self.relations:
            for a in r.attrs:
                seen.setdefault(a)
        return tuple(seen)

    def relations_of(self, attr: str) -> tuple[RelationSchema, ...]:
        return tuple(r for r in self.relations if attr in r)

    def occurrence_sets(self) -> dict[str, frozenset[str]]:
        """attr -> frozenset of relation names containing it."""
        return {
            a: frozenset(r.name for r in self.relations_of(a))
            for a in self.attributes
        }

    @property
    def join_attributes(self) -> tuple[str, ...]:
        """Attributes appearing in >= 2 relations."""
        occ = self.occurrence_sets()
        return tuple(a for a in self.attributes if len(occ[a]) >= 2)

    def relation(self, name: str) -> RelationSchema:
        for r in self.relations:
            if r.name == name:
                return r
        raise KeyError(name)

    def __str__(self) -> str:
        return " ⋈ ".join(str(r) for r in self.relations)


def make_query(spec: Mapping[str, Sequence[str]] | Iterable[tuple[str, Sequence[str]]]) -> JoinQuery:
    """Build a JoinQuery from {"R": ("A","B"), "S": ("B","C")}-style specs."""
    items = spec.items() if isinstance(spec, Mapping) else spec
    return JoinQuery(tuple(RelationSchema(n, tuple(a)) for n, a in items))


# ---- canonical join families (used by closed forms, tests, benches) -------

def chain_join(n: int, attr_prefix: str = "A", rel_prefix: str = "R") -> JoinQuery:
    """R_1(A0,A1) ⋈ R_2(A1,A2) ⋈ ... ⋈ R_n(A_{n-1}, A_n).  (paper §8.1)"""
    if n < 2:
        raise ValueError("chain needs n >= 2")
    rels = [
        RelationSchema(f"{rel_prefix}{i + 1}", (f"{attr_prefix}{i}", f"{attr_prefix}{i + 1}"))
        for i in range(n)
    ]
    return JoinQuery(tuple(rels))


def cycle_join(n: int, attr_prefix: str = "A", rel_prefix: str = "R") -> JoinQuery:
    """R_1(A0,A1) ⋈ ... ⋈ R_n(A_{n-1}, A0) — symmetric join with d=2 (§8.3)."""
    if n < 3:
        raise ValueError("cycle needs n >= 3")
    rels = [
        RelationSchema(
            f"{rel_prefix}{i + 1}",
            (f"{attr_prefix}{i}", f"{attr_prefix}{(i + 1) % n}"),
        )
        for i in range(n)
    ]
    return JoinQuery(tuple(rels))


def symmetric_join(n: int, d: int, attr_prefix: str = "A", rel_prefix: str = "R") -> JoinQuery:
    """Symmetric join (paper §8.3): n relations over n attributes, relation
    R_j = (A_j, A_{j+1}, ..., A_{j+d-1}) mod n.  Every attribute appears in
    exactly d relations; every size-d window of attributes appears in exactly
    one relation."""
    if not (1 <= d < n):
        raise ValueError("need 1 <= d < n")
    rels = [
        RelationSchema(
            f"{rel_prefix}{j + 1}",
            tuple(f"{attr_prefix}{(j + i) % n}" for i in range(d)),
        )
        for j in range(n)
    ]
    return JoinQuery(tuple(rels))


def star_join(n_dims: int) -> JoinQuery:
    """Fact(F, D1..Dn) ⋈ Dim_i(D_i, X_i) star schema."""
    fact = RelationSchema("F", tuple(["K"] + [f"D{i}" for i in range(n_dims)]))
    dims = [RelationSchema(f"T{i}", (f"D{i}", f"X{i}")) for i in range(n_dims)]
    return JoinQuery((fact, *dims))


# The paper's running examples -----------------------------------------------
def two_way() -> JoinQuery:
    """R(A,B) ⋈ S(B,C) — Examples 1, 2 and §9.1."""
    return make_query({"R": ("A", "B"), "S": ("B", "C")})


def three_way_paper() -> JoinQuery:
    """R(A,B) ⋈ S(B,E,C) ⋈ T(C,D) — Examples 5-8 and §9.2."""
    return make_query({"R": ("A", "B"), "S": ("B", "E", "C"), "T": ("C", "D")})


def triangle() -> JoinQuery:
    """R1(X1,X2) ⋈ R2(X2,X3) ⋈ R3(X3,X1) — §3 example."""
    return make_query({"R1": ("X1", "X2"), "R2": ("X2", "X3"), "R3": ("X3", "X1")})
