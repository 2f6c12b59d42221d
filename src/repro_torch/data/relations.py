"""Synthetic relation generators with controllable skew (paper §9 workloads).

Relations are columnar int64 arrays ``[N, arity]``.  ``zipf_relation``
produces a Zipf-distributed join column; ``paper_2way``/``paper_3way``
reproduce the experimental setups of §9.1/§9.2 (scaled by a factor so CPU
tests stay fast).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.schema import JoinQuery


def uniform_relation(
    rng: np.random.Generator, n: int, arity: int, domain: int
) -> np.ndarray:
    return rng.integers(0, domain, size=(n, arity), dtype=np.int64)


def skewed_column(
    rng: np.random.Generator,
    n: int,
    domain: int,
    hh_values: list[int],
    hh_fraction: float,
) -> np.ndarray:
    """A column where ``hh_fraction`` of entries are drawn uniformly from
    ``hh_values`` and the rest uniformly from the remaining domain."""
    col = rng.integers(0, domain, size=n, dtype=np.int64)
    # keep ordinary values clear of the HHs
    for v in hh_values:
        col[col == v] = (v + 1 + rng.integers(0, domain - 1)) % domain
        col[col == v] = (v + 7) % domain if domain > 7 else (v + 1) % domain
    n_hh = int(n * hh_fraction)
    if n_hh and hh_values:
        idx = rng.choice(n, size=n_hh, replace=False)
        col[idx] = rng.choice(np.asarray(hh_values, dtype=np.int64), size=n_hh)
    return col


def zipf_column(rng: np.random.Generator, n: int, domain: int, a: float = 1.5) -> np.ndarray:
    """Zipf(a) column folded into [0, domain)."""
    return (rng.zipf(a, size=n) - 1).astype(np.int64) % domain


def paper_2way(
    rng: np.random.Generator,
    n_r: int = 20_000,
    n_s: int = 2_000,
    domain: int = 100_000,
    hh_value: int = 7,
    hh_fraction: float = 0.10,
) -> dict[str, np.ndarray]:
    """§9.1: R(A,B) ⋈ S(B,C); |R| = 10 * |S|; one HH in B at 10% of tuples.

    Defaults are the paper's 10^6 / 10^5 setup scaled by 50x for CPU tests.
    """
    b_r = skewed_column(rng, n_r, domain, [hh_value], hh_fraction)
    b_s = skewed_column(rng, n_s, domain, [hh_value], hh_fraction)
    r = np.stack([rng.integers(0, domain, n_r, dtype=np.int64), b_r], axis=1)
    s = np.stack([b_s, rng.integers(0, domain, n_s, dtype=np.int64)], axis=1)
    return {"R": r, "S": s}


def paper_3way(
    rng: np.random.Generator,
    n: int = 4_000,
    domain: int = 50_000,
    hh_b: tuple[int, int] = (11, 13),
    hh_c: tuple[int, ...] = (17,),
    hh_fraction: float = 0.10,
) -> dict[str, np.ndarray]:
    """§9.2: R(A,B) ⋈ S(B,E,C) ⋈ T(C,D); each relation 10^5 tuples (scaled);
    B has two HHs, C one; HHs account for ~10% of the input."""
    b_r = skewed_column(rng, n, domain, list(hh_b), hh_fraction)
    b_s = skewed_column(rng, n, domain, list(hh_b), hh_fraction)
    c_s = skewed_column(rng, n, domain, list(hh_c), hh_fraction)
    c_t = skewed_column(rng, n, domain, list(hh_c), hh_fraction)
    r = np.stack([rng.integers(0, domain, n, dtype=np.int64), b_r], axis=1)
    s = np.stack([b_s, rng.integers(0, domain, n, dtype=np.int64), c_s], axis=1)
    t = np.stack([c_t, rng.integers(0, domain, n, dtype=np.int64)], axis=1)
    return {"R": r, "S": s, "T": t}


def random_join_data(
    rng: np.random.Generator,
    query: JoinQuery,
    n_per_relation: int,
    domain: int,
    skew_attr: str | None = None,
    hh_values: list[int] | None = None,
    hh_fraction: float = 0.0,
) -> dict[str, np.ndarray]:
    """Generic generator for any JoinQuery: shared attrs share a domain so
    joins are non-trivially selective; optional skew on one attribute."""
    data = {}
    for rel in query.relations:
        cols = []
        for attr in rel.attrs:
            if attr == skew_attr and hh_values:
                cols.append(
                    skewed_column(rng, n_per_relation, domain, hh_values, hh_fraction)
                )
            else:
                cols.append(rng.integers(0, domain, n_per_relation, dtype=np.int64))
        data[rel.name] = np.stack(cols, axis=1)
    return data
