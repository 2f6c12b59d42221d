"""The naive skew join of Example 1 (Pig/Hive-style, and [24]).

For R(A,B) ⋈ S(B,C) with heavy hitter b: partition the larger relation's
b-tuples across k reducers by hashing the *other* attribute, and broadcast
the smaller relation's b-tuples to all k.  Communication = r + k*s (r >= s).
Non-HH tuples go through an ordinary hash join on B.

This is the baseline SharesSkew beats (2*sqrt(k r s) < r + k*s); implemented
as a host-side cost/load model — benchmarks compare its telemetry with the
executor's measured telemetry under identical data.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .hashing import bucket_np


@dataclasses.dataclass(frozen=True)
class NaiveStats:
    comm_tuples: int
    reducer_loads: np.ndarray  # [k_hh + k_ord]
    k_hh: int
    k_ord: int

    @property
    def max_load(self) -> int:
        return int(self.reducer_loads.max())

    @property
    def load_imbalance(self) -> float:
        return float(self.reducer_loads.max() / self.reducer_loads.mean())


def naive_two_way(
    r_rows: np.ndarray,  # R(A, B)
    s_rows: np.ndarray,  # S(B, C)
    hh_values: np.ndarray,
    k_hh: int,
    k_ord: int,
    seed: int = 0xBEEF,
) -> NaiveStats:
    hh = np.asarray(hh_values, dtype=r_rows.dtype)
    r_is_hh = np.isin(r_rows[:, 1], hh)
    s_is_hh = np.isin(s_rows[:, 0], hh)
    loads = np.zeros(k_hh + k_ord, dtype=np.int64)

    # --- HH block: partition the bigger side, broadcast the smaller --------
    r_hh, s_hh = int(r_is_hh.sum()), int(s_is_hh.sum())
    if r_hh >= s_hh:
        part_col = r_rows[r_is_hh, 0]  # hash A
        np.add.at(loads, bucket_np(part_col, seed, k_hh).astype(np.int64), 1)
        loads[:k_hh] += s_hh  # broadcast S's HH tuples to all k_hh reducers
        comm_hh = r_hh + k_hh * s_hh
    else:
        part_col = s_rows[s_is_hh, 1]  # hash C
        np.add.at(loads, bucket_np(part_col, seed, k_hh).astype(np.int64), 1)
        loads[:k_hh] += r_hh
        comm_hh = s_hh + k_hh * r_hh

    # --- ordinary block: hash join on B -------------------------------------
    for col in (r_rows[~r_is_hh, 1], s_rows[~s_is_hh, 0]):
        b = bucket_np(col, seed + 1, k_ord).astype(np.int64) + k_hh
        np.add.at(loads, b, 1)
    comm_ord = int((~r_is_hh).sum() + (~s_is_hh).sum())

    return NaiveStats(
        comm_tuples=comm_hh + comm_ord,
        reducer_loads=loads,
        k_hh=k_hh,
        k_ord=k_ord,
    )
