"""Host-side reference oracle: exact multiway join via hash merges (numpy).

Computes (count, checksum, optionally materialized rows) for any JoinQuery.
The checksum uses the same per-relation tuple weights as the device path
(``hashing.row_weight_np``) summed over joined combinations mod 2^32, so
device results can be compared bit-for-bit.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from repro_torch.core.schema import JoinQuery

from .hashing import row_weight_np


def _join_two(
    left_rows: np.ndarray,
    left_attrs: list[str],
    left_w: np.ndarray,
    right_rows: np.ndarray,
    right_attrs: list[str],
    right_w: np.ndarray,
) -> tuple[np.ndarray, list[str], np.ndarray]:
    shared = [a for a in left_attrs if a in right_attrs]
    li = [left_attrs.index(a) for a in shared]
    ri = [right_attrs.index(a) for a in shared]
    buckets: dict[tuple, list[int]] = defaultdict(list)
    for j in range(right_rows.shape[0]):
        buckets[tuple(right_rows[j, ri])].append(j)
    out_left, out_right = [], []
    for i in range(left_rows.shape[0]):
        key = tuple(left_rows[i, li])
        for j in buckets.get(key, ()):
            out_left.append(i)
            out_right.append(j)
    keep = [a for a in right_attrs if a not in shared]
    ki = [right_attrs.index(a) for a in keep]
    if out_left:
        l_idx = np.asarray(out_left)
        r_idx = np.asarray(out_right)
        rows = np.concatenate(
            [left_rows[l_idx], right_rows[r_idx][:, ki]], axis=1
        )
        w = (left_w[l_idx].astype(np.uint64) * right_w[r_idx].astype(np.uint64)) & 0xFFFFFFFF
    else:
        rows = np.zeros((0, left_rows.shape[1] + len(keep)), dtype=left_rows.dtype)
        w = np.zeros(0, dtype=np.uint64)
    return rows, left_attrs + keep, w.astype(np.uint32)


def oracle_join(
    query: JoinQuery,
    data: dict[str, np.ndarray],
    weight_seed: int = 0x5EED,
) -> tuple[int, int, np.ndarray, list[str]]:
    """Returns (count, checksum_uint32, rows, attr_order).

    checksum = sum over join results of prod_i weight_i(tuple_i) mod 2^32 —
    identical to the device computation (weights multiply in uint32 wrap
    because all intermediate weights stay < 2^32 via masking each step;
    the device multiplies in int32 two's complement which matches mod 2^32).
    """
    rels = query.relations
    rows = np.asarray(data[rels[0].name], dtype=np.int64)
    attrs = list(rels[0].attrs)
    w = row_weight_np(rows, weight_seed + 0).astype(np.uint32)
    for i, rel in enumerate(rels[1:], start=1):
        r = np.asarray(data[rel.name], dtype=np.int64)
        rw = row_weight_np(r, weight_seed + i).astype(np.uint32)
        rows, attrs, w = _join_two(rows, attrs, w, r, list(rel.attrs), rw)
    count = rows.shape[0]
    checksum = int(np.sum(w.astype(np.uint64)) & 0xFFFFFFFF)
    return count, checksum, rows, attrs


def groupby_oracle_two_way(
    query: JoinQuery,
    data: dict[str, np.ndarray],
    weight_seed: int = 0x5EED,
) -> tuple[int, int]:
    """(count, checksum_uint32) of a two-relation join by grouping on the
    shared attributes, without materialising the result: count =
    sum_b c_R(b) * c_S(b) and checksum = sum_b W_R(b) * W_S(b) mod 2^32,
    where W is the sum of row weights with key b.  Equals ``oracle_join``
    where that would need too many rows."""
    if len(query.relations) != 2:
        raise ValueError("groupby_oracle_two_way is for two-relation joins")
    r_rel, s_rel = query.relations
    shared = [a for a in r_rel.attrs if a in s_rel.attrs]
    r = np.asarray(data[r_rel.name], dtype=np.int64)
    s = np.asarray(data[s_rel.name], dtype=np.int64)
    rw = row_weight_np(r, weight_seed).astype(np.uint64)
    sw = row_weight_np(s, weight_seed + 1).astype(np.uint64)
    rk = r[:, [r_rel.index_of(a) for a in shared]]
    sk = s[:, [s_rel.index_of(a) for a in shared]]
    if not shared:  # cross product: one group
        rk, sk = np.zeros((len(r), 1), np.int64), np.zeros((len(s), 1), np.int64)
    _, inv = np.unique(np.concatenate([rk, sk]), axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    g = int(inv.max()) + 1 if inv.size else 0
    ri, si = inv[: len(r)], inv[len(r):]
    count = int(np.dot(np.bincount(ri, minlength=g), np.bincount(si, minlength=g)))
    # per-group weight sums stay far below 2^53, so float64 bincount is exact;
    # their products wrap mod 2^64, which keeps them exact mod 2^32
    wr = np.bincount(ri, weights=rw, minlength=g).astype(np.uint64)
    ws = np.bincount(si, weights=sw, minlength=g).astype(np.uint64)
    checksum = int(np.sum(wr * ws, dtype=np.uint64) & np.uint64(0xFFFFFFFF))
    return count, checksum
