"""Reduce-phase primitives: bin emissions by reducer, join locally.

Grouping uses a stable sort + rank-in-group scatter.  A binary join (two
relations, one link) is reduced by the hand-written CUDA block-join kernel
(``repro_torch.kernels.block_join``), over slices of R's rows where a
reducer's bins could hold 2^31 pairs or more (the kernel counts in int32);
an n-way join, or a cross product,
contracts its pairwise match matrices one relation at a time by
broadcast-multiply-and-sum in int64 — PyTorch has no integer matmul on
CUDA, so no ``einsum``/``bmm`` on integers is used.

Join *outputs* are returned as (count, checksum) rather than materialized
tuples: output size is data-dependent, while count + an orderless
hash-weighted checksum give a complete correctness fingerprint against the
host oracle.  A capacity-bounded materialization is provided for 2-way
joins.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.schema import JoinQuery
from repro_torch.kernels import block_join

from .hashing import row_weight_torch

_MAX_RELATIONS = 10
_M32 = 0xFFFFFFFF
_NWAY_CHUNK = 1 << 24  # int64 elements in the largest n-way intermediate


def group_by_reducer(
    dests: torch.Tensor,  # [M] int32 global reducer ids, -1 = dropped
    rows: torch.Tensor,  # [M, arity]
    num_reducers: int,
    cap: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scatter emissions into per-reducer bins.

    Returns (bins [K, cap, arity], valid [K, cap], loads [K] int32,
    overflow).  ``loads`` counts *all* arrivals (pre-capacity) so skew is
    observable; ``overflow`` counts tuples dropped because a bin exceeded
    cap.  Within a bin, tuples keep their order in ``dests`` (stable sort).
    """
    m = dests.shape[0]
    k = num_reducers
    dev = dests.device
    d = torch.where(dests >= 0, dests, k).to(torch.int64)  # invalid -> bin k
    ds, order = torch.sort(d, stable=True)
    rs = rows[order]
    # rank within group: position - first index of this dest value
    first = torch.searchsorted(ds, ds, side="left")
    rank = torch.arange(m, dtype=torch.int64, device=dev) - first
    ok = (ds < k) & (rank < cap)
    # scatter; dropped rows all land in the scratch bin k
    bid = torch.where(ok, ds, k)
    rid = torch.where(ok, rank, 0)
    bins = torch.zeros((k + 1, cap, rows.shape[1]), dtype=rows.dtype, device=dev)
    bins[bid, rid] = rs
    valid = torch.zeros((k + 1, cap), dtype=torch.bool, device=dev)
    valid[bid, rid] = ok
    # arrivals per bin from the sorted ids: no host sync (CUDA bincount reads
    # its input's max on the host)
    edges = torch.searchsorted(ds, torch.arange(k + 1, device=dev))
    loads = (edges[1:] - edges[:-1]).to(torch.int32)
    overflow = ((ds < k) & (rank >= cap)).sum()
    return bins[:k], valid[:k], loads, overflow


@dataclasses.dataclass(frozen=True)
class LocalJoinSpec:
    """Static join structure: which relation pairs share which columns."""

    rel_names: tuple[str, ...]
    # (rel_i, rel_j, ((col_in_i, col_in_j), ...)) for every linked pair i<j
    links: tuple[tuple[int, int, tuple[tuple[int, int], ...]], ...]

    @classmethod
    def from_query(cls, query: JoinQuery) -> "LocalJoinSpec":
        rels = query.relations
        links = []
        for i in range(len(rels)):
            for j in range(i + 1, len(rels)):
                shared = [a for a in rels[i].attrs if a in rels[j].attrs]
                if shared:
                    links.append(
                        (
                            i,
                            j,
                            tuple(
                                (rels[i].index_of(a), rels[j].index_of(a))
                                for a in shared
                            ),
                        )
                    )
        if len(rels) > _MAX_RELATIONS:
            raise ValueError("joins over >10 relations not supported")
        return cls(tuple(r.name for r in rels), tuple(links))

    @property
    def is_binary(self) -> bool:
        """Two relations joined on one link: the block-join kernel's case."""
        return len(self.rel_names) == 2 and len(self.links) == 1


def _match_matrix(
    bi: torch.Tensor, vi: torch.Tensor, bj: torch.Tensor, vj: torch.Tensor, cols
) -> torch.Tensor:
    """Batched pairwise equality: bi [K,ca,arity], bj [K,cb,arity] ->
    [K, ca, cb] bool."""
    m = vi[:, :, None] & vj[:, None, :]
    for ci, cj in cols:
        m &= bi[:, :, ci][:, :, None] == bj[:, :, cj][:, None, :]
    return m


def _mul_mod32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 a, b in [0, 2^32), with no int64 overflow."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _elimination_order(labels, caps):
    """Greedy order for summing out relations: each step picks the relation
    whose factors span the fewest elements per reducer.  Returns
    [(relation, union of the labels it touches)]."""
    labels = [frozenset(ls) for ls in labels]
    order = []
    for _ in range(len(caps)):
        left = sorted(set().union(*labels))

        def union(i):
            return frozenset().union(*(ls for ls in labels if i in ls))

        i = min(left, key=lambda i: math.prod(caps[a] for a in union(i)))
        u = union(i)
        order.append((i, tuple(sorted(u))))
        labels = [ls for ls in labels if i not in ls] + [u - {i}]
    return order


def _contract(factors, order, caps, mod32: bool) -> torch.Tensor:
    """Sum the product of ``factors`` (labels, [kc, *caps[labels]]) over every
    relation index; returns [kc] int64 (reduced mod 2^32 if ``mod32``)."""
    factors = list(factors)
    for i, union in order:
        acc = None
        rest = []
        for labels, t in factors:
            if i not in labels:
                rest.append((labels, t))
                continue
            t = t.reshape(t.shape[0], *[caps[u] if u in labels else 1 for u in union])
            if acc is None:
                acc = t
            else:
                acc = _mul_mod32(acc, t) if mod32 else acc * t
        out = acc.sum(dim=1 + union.index(i))
        if mod32:
            out = out & _M32
        rest.append((tuple(u for u in union if u != i), out))
        factors = rest
    out = None
    for _, t in factors:  # every label summed out: one [kc] per component
        if out is None:
            out = t
        else:
            out = _mul_mod32(out, t) if mod32 else out * t
    return out


def _valid_extent(valid: torch.Tensor) -> int:
    """One past the last slot that is valid in any reducer's bin."""
    if valid.numel() == 0:
        return 0
    pos = torch.arange(1, valid.shape[1] + 1, device=valid.device)
    return int((valid * pos).amax())


def _nway_count_checksum(spec, bins, valids, weights):
    names = spec.rel_names
    # slots past the last valid one contribute nothing: cut them, since the
    # contraction's work grows with the product of the bin widths
    ext = {n: _valid_extent(valids[n]) for n in names}
    bins = {n: bins[n][:, : ext[n]] for n in names}
    valids = {n: valids[n][:, : ext[n]] for n in names}
    weights = {n: weights[n][:, : ext[n]] for n in names}
    caps = [ext[n] for n in names]
    k = valids[names[0]].shape[0]
    covered = {i for i, _, _ in spec.links} | {j for _, j, _ in spec.links}
    uncovered = [i for i in range(len(names)) if i not in covered]
    labels = [(i, j) for i, j, _ in spec.links] + [(i,) for i in uncovered]
    order = _elimination_order(labels, caps)
    widest = max(math.prod(caps[a] for a in u) for _, u in order)
    step = max(1, _NWAY_CHUNK // max(widest, 1))
    count = torch.zeros((), dtype=torch.int64, device=valids[names[0]].device)
    checksum = torch.zeros_like(count)
    for k0 in range(0, k, step):
        ks = slice(k0, k0 + step)
        match = [
            ((i, j), _match_matrix(
                bins[names[i]][ks], valids[names[i]][ks],
                bins[names[j]][ks], valids[names[j]][ks], cols,
            ).to(torch.int64))
            for i, j, cols in spec.links
        ]
        ones = [((i,), valids[names[i]][ks].to(torch.int64)) for i in uncovered]
        w = [((i,), weights[n][ks].to(torch.int64)) for i, n in enumerate(names)]
        count = count + _contract(match + ones, order, caps, False).sum()
        part = _contract(match + ones + w, order, caps, True).sum()
        checksum = (checksum + part) & _M32
    return count, checksum


def _bin_weights(spec, bins, valids, weight_seed):
    """Per relation, [K, cap] int32 row weights, 0 on invalid slots."""
    weights = {}
    for i, name in enumerate(spec.rel_names):
        b, v = bins[name], valids[name]
        w = row_weight_torch(b.reshape(-1, b.shape[-1]), weight_seed + i)
        weights[name] = torch.where(v, w.reshape(v.shape), 0)
    return weights


def _binary_operands(spec, bins, weights):
    (i, j, cols), = spec.links
    ni, nj = spec.rel_names[i], spec.rel_names[j]
    r_keys = bins[ni][:, :, [ci for ci, _ in cols]].to(torch.int32).contiguous()
    s_keys = bins[nj][:, :, [cj for _, cj in cols]].to(torch.int32).contiguous()
    return r_keys, weights[ni].contiguous(), s_keys, weights[nj].contiguous()


def binary_join_operands(
    spec: LocalJoinSpec,
    bins: dict[str, torch.Tensor],
    valids: dict[str, torch.Tensor],
    weight_seed: int = 0x5EED,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The (r_keys, r_weights, s_keys, s_weights) that
    ``local_join_count_checksum`` hands the block-join kernel for a binary
    join: the link's key columns [K, cap, C] and the weights [K, cap]."""
    if not spec.is_binary:
        raise ValueError("binary_join_operands is for binary joins")
    return _binary_operands(spec, bins, _bin_weights(spec, bins, valids, weight_seed))


def local_join_count_checksum(
    spec: LocalJoinSpec,
    bins: dict[str, torch.Tensor],  # name -> [K, cap, arity]
    valids: dict[str, torch.Tensor],  # name -> [K, cap]
    weight_seed: int = 0x5EED,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-reducer-batched multiway join.  Returns (count, checksum) as int64
    scalars on the bins' device.

    checksum = sum over joined tuples of the product of per-relation tuple
    weights (mod 2^32, in [0, 2^32)) — orderless, matches the oracle.  The
    count is summed in int64, so it does not wrap at 2^31.
    """
    weights = _bin_weights(spec, bins, valids, weight_seed)
    if not spec.is_binary:
        return _nway_count_checksum(spec, bins, valids, weights)
    return _binary_count_checksum(*_binary_operands(spec, bins, weights))


def slice_rows(cap_r: int, cap_s: int) -> int:
    """R rows a slice of the binary join: the slices are as equal as they
    can be, and each has fewer than ``block_join.PAIR_LIMIT`` pairs."""
    most = max(1, (block_join.PAIR_LIMIT - 1) // max(cap_s, 1))
    return max(1, -(-cap_r // -(-cap_r // most)))


def _binary_count_checksum(
    r_keys: torch.Tensor, r_weights: torch.Tensor, s_keys: torch.Tensor, s_weights: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The block join summed over reducers: int64 count, checksum mod 2^32.
    The kernel counts a reducer's pairs in int32, so where cap_r * cap_s
    reaches ``block_join.PAIR_LIMIT`` R's rows go in equal slices whose
    product with cap_s stays below it; counts and checksums add over a
    partition of R's rows, so the sums are one join's."""
    cap_r, cap_s = r_keys.shape[1], s_keys.shape[1]
    step = slice_rows(cap_r, cap_s)
    count = torch.zeros((), dtype=torch.int64, device=r_keys.device)
    checksum = torch.zeros((), dtype=torch.int64, device=r_keys.device)
    for lo in range(0, max(cap_r, 1), step):
        part = slice(lo, lo + step)
        cnt, chk = block_join.reducer_join(
            r_keys[:, part].contiguous(), r_weights[:, part].contiguous(), s_keys, s_weights)
        count += cnt.to(torch.int64).sum()
        checksum = (checksum + (chk.to(torch.int64) & _M32).sum()) & _M32
    return count, checksum


def materialize_two_way(
    spec: LocalJoinSpec,
    bins: dict[str, torch.Tensor],
    valids: dict[str, torch.Tensor],
    out_cap: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """2-way joins only: emit joined rows [out_cap, arity_l + arity_r]
    (zero-padded), their validity mask, and an overflow count."""
    if len(spec.rel_names) != 2:
        raise ValueError("materialize_two_way is for 2-way joins")
    (i, j, cols), = spec.links
    li, lj = spec.rel_names[i], spec.rel_names[j]
    m = _match_matrix(bins[li], valids[li], bins[lj], valids[lj], cols)  # [K,ca,cb]
    k, ca, cb = m.shape
    flat = m.reshape(-1)
    total = flat.shape[0]
    idx = torch.nonzero(flat).flatten()[:out_cap]
    pad = torch.full((out_cap - idx.shape[0],), total, dtype=idx.dtype, device=idx.device)
    idx = torch.cat([idx, pad])
    ok = idx < total
    idx = torch.where(ok, idx, 0)
    kk = idx // (ca * cb)
    ra = (idx // cb) % ca
    rb = idx % cb
    left = bins[li][kk, ra]
    right = bins[lj][kk, rb]
    rows = torch.cat([left, right], dim=-1)
    rows = torch.where(ok[:, None], rows, 0)
    overflow = torch.clamp(m.sum() - ok.sum(), min=0)
    return rows, ok, overflow
