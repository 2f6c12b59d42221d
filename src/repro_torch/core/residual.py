"""Residual-join enumeration and subsumption (paper §4.1, §5.1).

For each attribute X, the set of *types* L_X is {T_-} ∪ {T_b : b heavy
hitter of X}.  A *combination* C_T picks one type per attribute and defines
a residual join: the original join applied to the tuples that satisfy C_T's
constraints (ordinary type excludes all HH values of that attribute;
pinned type T_b keeps only X = b).

Subsumption (§5.1): a combination pinning B = b is unnecessary when, under
the subsuming combination's share x_B, the HH's tuples fit inside an
average hash bucket anyway — for every relation R containing B:

    x_B < relevant_size_R / count_R(b)        (paper's condition)

i.e. hashing on B spreads b's tuples no worse than ordinary values.  We
apply this as a fixed-point *demotion* loop on HH values (a demoted value
becomes ordinary everywhere), which is exactly the pairwise rule for
single-pinned combinations and a sound approximation for multi-pinned ones
(a value harmless under the all-ordinary shares is harmless under any
residual whose shares for B can only shrink relative sizes).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Mapping

import numpy as np

from .heavy_hitters import exact_heavy_hitters
from .schema import JoinQuery
from .shares import SharesSolution, solve_k_for_capacity

ORDINARY = None  # type marker for T_-


@dataclasses.dataclass(frozen=True)
class Combination:
    """A combination of types: attr -> pinned HH value, or ORDINARY.

    Only attributes that have heavy hitters appear; everything else is
    implicitly ordinary.
    """

    types: tuple[tuple[str, int | None], ...]  # sorted by attr

    @classmethod
    def of(cls, mapping: Mapping[str, int | None]) -> "Combination":
        return cls(tuple(sorted(mapping.items())))

    def as_dict(self) -> dict[str, int | None]:
        return dict(self.types)

    @property
    def pinned(self) -> dict[str, int]:
        return {a: v for a, v in self.types if v is not ORDINARY}

    def __str__(self) -> str:
        parts = [f"{a}={'_' if v is ORDINARY else v}" for a, v in self.types]
        return "{" + ", ".join(parts) + "}"


def relevant_mask(
    rel_array: np.ndarray,
    rel_attrs: tuple[str, ...],
    combo: Combination,
    hh_values: Mapping[str, np.ndarray],
) -> np.ndarray:
    """Boolean mask of tuples of one relation relevant to ``combo``."""
    mask = np.ones(rel_array.shape[0], dtype=bool)
    cd = combo.as_dict()
    for j, attr in enumerate(rel_attrs):
        if attr not in cd:
            continue
        col = rel_array[:, j]
        if cd[attr] is ORDINARY:
            hh = hh_values.get(attr)
            if hh is not None and len(hh):
                mask &= ~np.isin(col, hh)
        else:
            mask &= col == cd[attr]
    return mask


def relevant_sizes(
    query: JoinQuery,
    data: Mapping[str, np.ndarray],
    combo: Combination,
    hh_values: Mapping[str, np.ndarray],
) -> dict[str, int]:
    return {
        r.name: int(
            relevant_mask(np.asarray(data[r.name]), r.attrs, combo, hh_values).sum()
        )
        for r in query.relations
    }


def detect_heavy_hitters(
    query: JoinQuery,
    data: Mapping[str, np.ndarray],
    threshold: float,
    candidate_attrs: tuple[str, ...],
    max_hh_per_attr: int = 8,
) -> dict[str, np.ndarray]:
    """Per candidate attribute, values whose count in ANY relation containing
    the attribute reaches ``threshold`` (the paper's preliminary round)."""
    out: dict[str, np.ndarray] = {}
    for attr in candidate_attrs:
        found: dict[int, int] = {}
        for rel in query.relations_of(attr):
            col = np.asarray(data[rel.name])[:, rel.index_of(attr)]
            vals, counts = exact_heavy_hitters(col, threshold)
            for v, c in zip(vals.tolist(), counts.tolist()):
                found[v] = max(found.get(v, 0), c)
        if found:
            top = sorted(found.items(), key=lambda kv: -kv[1])[:max_hh_per_attr]
            out[attr] = np.array([v for v, _ in top], dtype=np.int64)
    return out


def max_count_in_relations(
    query: JoinQuery, data: Mapping[str, np.ndarray], attr: str, value: int
) -> dict[str, int]:
    """count_R(value) for every relation R containing attr."""
    out = {}
    for rel in query.relations_of(attr):
        col = np.asarray(data[rel.name])[:, rel.index_of(attr)]
        out[rel.name] = int((col == value).sum())
    return out


def prune_by_subsumption(
    query: JoinQuery,
    data: Mapping[str, np.ndarray],
    hh_values: dict[str, np.ndarray],
    q: float,
    k_max: int = 1 << 22,
) -> tuple[dict[str, np.ndarray], SharesSolution, int]:
    """Fixed-point demotion of subsumed HH values (see module docstring).

    Returns (surviving hh_values, all-ordinary solution, its k).
    """
    hh = {a: np.asarray(v, dtype=np.int64) for a, v in hh_values.items() if len(v)}
    while True:
        ordinary = Combination.of({a: ORDINARY for a in hh})
        sizes = relevant_sizes(query, data, ordinary, hh)
        k0, sol0 = solve_k_for_capacity(query, sizes, q, frozenset(), k_max)
        demoted = False
        for attr in list(hh):
            x_b = sol0.shares.get(attr, 1.0)
            keep = []
            for v in hh[attr].tolist():
                counts = max_count_in_relations(query, data, attr, int(v))
                # paper §5.1: subsumed when x_B < r_R / count_R(b) for all R
                harmless = all(
                    x_b < (sizes[rn] / c if c else float("inf")) or c == 0
                    for rn, c in counts.items()
                )
                if harmless:
                    demoted = True
                else:
                    keep.append(v)
            if keep:
                hh[attr] = np.array(keep, dtype=np.int64)
            else:
                del hh[attr]
                demoted = demoted or True
        if not demoted:
            return hh, sol0, k0
        if not hh:
            ordinary = Combination.of({})
            sizes = relevant_sizes(query, data, ordinary, hh)
            k0, sol0 = solve_k_for_capacity(query, sizes, q, frozenset(), k_max)
            return hh, sol0, k0


def enumerate_combinations(
    hh_values: Mapping[str, np.ndarray], max_combos: int = 1024
) -> list[Combination]:
    """Cartesian product of L_X over HH attributes (§5.1)."""
    attrs = sorted(hh_values)
    options = [[ORDINARY] + list(np.asarray(hh_values[a]).tolist()) for a in attrs]
    n = 1
    for o in options:
        n *= len(o)
    if n > max_combos:
        raise ValueError(
            f"{n} residual joins exceeds max_combos={max_combos}; "
            "raise the HH threshold or cap HHs per attribute"
        )
    return [
        Combination.of(dict(zip(attrs, choice)))
        for choice in itertools.product(*options)
    ]
