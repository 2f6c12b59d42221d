"""Map-phase key generation (paper §5.2 Map step + recursive_keys).

The paper builds, per tuple and per compatible residual join, the set of
reducer keys: hash the attributes the tuple owns (marked ``h``), fix share-1
attributes (marked ``1``), and *replicate* over the grid dimensions of
share attributes the tuple lacks (marked ``r`` — the recursive_keys
enumeration).  Here that enumeration is vectorized: for each
(relation, residual) pair the replication pattern is static, so key
generation is an elementwise torch computation emitting a dense
``[N, replication]`` block of global reducer ids (−1 where the tuple is not
relevant to the residual).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.planner import ResidualPlan, SharesSkewPlan
from repro_torch.core.residual import ORDINARY
from repro_torch.core.schema import RelationSchema

from .hashing import attr_seed, bucket_torch


@dataclasses.dataclass(frozen=True)
class RouteSpec:
    """Static routing recipe for one (relation, residual) pair.

    Global reducer id = offset + sum_i coord_i * stride_i over grid attrs.
    ``hashed``: (col_in_relation, seed, dim, stride) for attrs the tuple owns.
    ``replicated``: (dim, stride) for grid attrs the tuple lacks; the tuple is
    sent to every coordinate — the paper's ``r`` mark.
    ``pins``: (col, value) equality constraints (this residual's HHs).
    ``ordinary_excludes``: (col, values[]) — attrs of ordinary type exclude
    the attribute's HH values.
    """

    rel_name: str
    residual_index: int
    offset: int
    hashed: tuple[tuple[int, int, int, int], ...]
    replicated: tuple[tuple[int, int], ...]
    pins: tuple[tuple[int, int], ...]
    ordinary_excludes: tuple[tuple[int, tuple[int, ...]], ...]

    @property
    def replication(self) -> int:
        return math.prod(d for d, _ in self.replicated) if self.replicated else 1

    # ---- vectorized recursive_keys -----------------------------------------
    def replica_offsets(self) -> np.ndarray:
        """Flat id offsets of the replicated coordinates ([replication])."""
        if not self.replicated:
            return np.zeros(1, dtype=np.int32)
        grids = np.meshgrid(
            *[np.arange(d, dtype=np.int32) for d, _ in self.replicated],
            indexing="ij",
        )
        flat = sum(
            g.reshape(-1) * np.int32(stride)
            for g, (_, stride) in zip(grids, self.replicated)
        )
        return flat.astype(np.int32)

    def destinations(self, rows: torch.Tensor) -> torch.Tensor:
        """[N, replication] int32 global reducer ids; −1 where not relevant.

        ``rows`` is an int32 [N, arity] tensor on any device."""
        n = rows.shape[0]
        base = torch.full((n,), self.offset, dtype=torch.int32, device=rows.device)
        for col, seed, dim, stride in self.hashed:
            base = base + bucket_torch(rows[:, col], seed, dim) * stride
        mask = torch.ones(n, dtype=torch.bool, device=rows.device)
        for col, value in self.pins:
            mask &= rows[:, col] == value
        for col, values in self.ordinary_excludes:
            v = rows[:, col]
            for hv in values:
                mask &= v != hv
        rep = torch.from_numpy(self.replica_offsets()).to(rows.device)  # [R]
        dest = base[:, None] + rep[None, :]
        return torch.where(mask[:, None], dest, torch.full_like(dest, -1))


def build_route_specs(
    plan: SharesSkewPlan, rel: RelationSchema
) -> tuple[RouteSpec, ...]:
    """All routing recipes for one relation across the plan's residuals."""
    specs = []
    for ridx, res in enumerate(plan.residuals):
        specs.append(_route_for(plan, ridx, res, rel))
    return tuple(specs)


def _route_for(
    plan: SharesSkewPlan, ridx: int, res: ResidualPlan, rel: RelationSchema
) -> RouteSpec:
    dims = dict(zip(res.grid_attrs, res.grid_dims))
    # strides: row-major over grid_attrs order
    strides: dict[str, int] = {}
    acc = 1
    for a in reversed(res.grid_attrs):
        strides[a] = acc
        acc *= dims[a]
    hashed = []
    replicated = []
    for a in res.grid_attrs:
        if a in rel.attrs:
            hashed.append((rel.index_of(a), attr_seed(ridx, a), dims[a], strides[a]))
        else:
            replicated.append((dims[a], strides[a]))
    pins = []
    excludes = []
    combo = res.combo.as_dict()
    for a, v in combo.items():
        if a not in rel.attrs:
            continue
        col = rel.index_of(a)
        if v is ORDINARY:
            hh = plan.hh_values.get(a)
            if hh is not None and len(hh):
                excludes.append((col, tuple(int(x) for x in np.asarray(hh))))
        else:
            pins.append((col, int(v)))
    return RouteSpec(
        rel_name=rel.name,
        residual_index=ridx,
        offset=res.reducer_offset,
        hashed=tuple(hashed),
        replicated=tuple(replicated),
        pins=tuple(pins),
        ordinary_excludes=tuple(excludes),
    )


def map_phase(
    plan: SharesSkewPlan, rel: RelationSchema, rows: torch.Tensor
) -> torch.Tensor:
    """Full map step for one relation: concat of per-residual destination
    blocks -> [N, total_width] global reducer ids (−1 = not emitted).
    Columns are residual-major, replica-minor."""
    specs = build_route_specs(plan, rel)
    blocks = [s.destinations(rows) for s in specs]
    return torch.cat(blocks, dim=1)


def static_route_table(
    plan: SharesSkewPlan, rel: RelationSchema
) -> tuple[tuple, ...]:
    """The plan's routing recipes for one relation as an all-static,
    hashable tuple — the form a fused ingest kernel takes, whose
    destination math must match ``map_phase`` bit-for-bit, column layout
    included."""
    out = []
    for s in build_route_specs(plan, rel):
        rep = tuple(int(x) for x in s.replica_offsets().tolist())
        out.append((s.offset, s.hashed, rep, s.pins, s.ordinary_excludes))
    return tuple(out)
