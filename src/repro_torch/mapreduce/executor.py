"""End-to-end SharesSkew join execution on PyTorch (paper §5.2 stage 4 +
reduce).

``run_join`` runs single-process on one device: map -> bin-by-reducer ->
reduce-side join, with every logical reducer tiled on that device (the
paper's Reduce task hosting many reducers).  Binary joins are reduced by
the CUDA block-join kernel; n-way joins by int64 contraction.
``run_join_speculative`` splits the reduce into shards of residual joins
run under speculative re-execution (``mapreduce.straggler``), each shard a
``run_join`` on the same device.

Results carry communication and per-reducer-load telemetry so benchmarks can
reproduce the paper's Figures 1-3 (shuffle cost, load skew).
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch.core.planner import ResidualPlan, SharesSkewPlan
from repro_torch.core.schema import JoinQuery

from .keys import map_phase
from .local_join import LocalJoinSpec, group_by_reducer, local_join_count_checksum


@dataclasses.dataclass(frozen=True)
class JoinResult:
    count: int
    checksum: int
    comm_tuples: dict[str, int]  # tuples shipped mapper->reducer per relation
    reducer_loads: np.ndarray  # [K] total arrivals per reducer (all relations)
    overflow: int  # tuples dropped by capacity (must be 0 for valid runs)

    @property
    def total_comm(self) -> int:
        return int(sum(self.comm_tuples.values()))

    @property
    def max_load(self) -> int:
        return int(self.reducer_loads.max()) if self.reducer_loads.size else 0

    @property
    def load_imbalance(self) -> float:
        """max / mean reducer load — the skew the paper fights."""
        loads = self.reducer_loads
        if loads.size == 0 or loads.mean() == 0:
            return 0.0
        return float(loads.max() / loads.mean())


def _device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on; a CUDA device without a card
    raises rather than falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain versions"
        )
    return dev


def _bin_cap(plan: SharesSkewPlan, cap_factor: float) -> int:
    cap = int(math.ceil(plan.q * cap_factor)) + 8
    return max(16, cap)


def _rows(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    # wrap to int32 as the reference executor does before mapping
    return torch.from_numpy(np.ascontiguousarray(np.asarray(arr).astype(np.int32))).to(dev)


class _Laps:
    """Seconds per phase, synchronising the device at each boundary; a
    no-op unless the caller asked for phase times."""

    def __init__(self, out: dict | None, dev: torch.device):
        self.out, self.dev = out, dev
        self.t = time.perf_counter()

    def __call__(self, phase: str) -> None:
        if self.out is None:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        now = time.perf_counter()
        self.out[phase] = self.out.get(phase, 0.0) + (now - self.t)
        self.t = now


def _map_and_bin(query, data, plan, cap_factor, dev, lap):
    cap = _bin_cap(plan, cap_factor)
    k = plan.total_reducers
    rows_by_rel = {rel.name: _rows(data[rel.name], dev) for rel in query.relations}
    lap("upload")
    bins, valids, comm = {}, {}, {}
    loads_total = torch.zeros(k, dtype=torch.int32, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    for rel in query.relations:
        rows = rows_by_rel[rel.name]
        dest = map_phase(plan, rel, rows)  # [N, W]
        n, w = dest.shape
        flat_dest = dest.reshape(-1)
        flat_rows = rows[:, None, :].expand(n, w, rows.shape[1]).reshape(-1, rows.shape[1])
        comm[rel.name] = (flat_dest >= 0).sum()
        lap("map")
        b, v, loads, ov = group_by_reducer(flat_dest, flat_rows, k, cap)
        bins[rel.name], valids[rel.name] = b, v
        loads_total += loads
        overflow += ov
        lap("bin")
    return bins, valids, comm, loads_total, overflow


def map_and_bin(
    query: JoinQuery,
    data: dict[str, np.ndarray],
    plan: SharesSkewPlan,
    cap_factor: float = 3.0,
    device: str | torch.device = "cuda",
) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """The bins and valid masks that ``run_join`` hands its reduce phase:
    per relation, [K, cap, arity] and [K, cap] on ``device``."""
    dev = _device(device)
    bins, valids, _, _, _ = _map_and_bin(
        query, data, plan, cap_factor, dev, _Laps(None, dev)
    )
    return bins, valids


def run_join(
    query: JoinQuery,
    data: dict[str, np.ndarray],
    plan: SharesSkewPlan,
    cap_factor: float = 3.0,
    device: str | torch.device = "cuda",
    phase_seconds: dict | None = None,
) -> JoinResult:
    """Execute the plan single-process on ``device``.  ``cap_factor`` scales
    the per-reducer bin capacity above the expected load q (hash variance
    headroom).  When ``phase_seconds`` is a dict, the seconds spent in the
    upload, map, bin and reduce phases are added to it (the device is
    synchronised at each phase boundary)."""
    dev = _device(device)
    if not plan.residuals:  # some relation is empty -> join is empty
        return JoinResult(
            count=0,
            checksum=0,
            comm_tuples={r.name: 0 for r in query.relations},
            reducer_loads=np.zeros(0, dtype=np.int32),
            overflow=0,
        )
    lap = _Laps(phase_seconds, dev)
    bins, valids, comm, loads_total, overflow = _map_and_bin(
        query, data, plan, cap_factor, dev, lap
    )
    count, checksum = local_join_count_checksum(
        LocalJoinSpec.from_query(query), bins, valids
    )
    result = JoinResult(
        count=int(count),
        checksum=int(checksum),
        comm_tuples={n: int(c) for n, c in comm.items()},
        reducer_loads=loads_total.cpu().numpy(),
        overflow=int(overflow),
    )
    lap("reduce")
    return result


def measure_loads(
    query: JoinQuery,
    data: dict[str, np.ndarray],
    plan: SharesSkewPlan,
    device: str | torch.device = "cuda",
) -> JoinResult:
    """Map phase only: routes every tuple and tallies per-reducer arrivals
    and shuffle volume WITHOUT executing the reduce-side join.  Used to
    profile load skew where actually materializing the reducers would be
    prohibitively large (e.g. plain Shares on heavily skewed data)."""
    dev = _device(device)
    k = plan.total_reducers
    if k == 0:
        return JoinResult(0, 0, {r.name: 0 for r in query.relations},
                          np.zeros(0, np.int32), 0)
    loads = torch.zeros(k, dtype=torch.int64, device=dev)
    comm = {}
    for rel in query.relations:
        dest = map_phase(plan, rel, _rows(data[rel.name], dev)).reshape(-1)
        valid = dest[dest >= 0].to(torch.int64)
        loads += torch.bincount(valid, minlength=k)
        comm[rel.name] = int(valid.shape[0])
    return JoinResult(
        count=-1,  # join not executed
        checksum=0,
        comm_tuples=comm,
        reducer_loads=loads.cpu().numpy(),
        overflow=0,
    )


def predicted_comm(plan: SharesSkewPlan) -> dict[str, int]:
    """Exact communication the executor will produce: per relation, the sum
    over residuals of relevant_size x replication (integer shares)."""
    out: dict[str, int] = {r.name: 0 for r in plan.query.relations}
    for res in plan.residuals:
        for rel in plan.query.relations:
            out[rel.name] += res.sizes[rel.name] * res.int_replication(rel.attrs)
    return out


def run_join_speculative(
    query: JoinQuery,
    data: dict[str, np.ndarray],
    plan: SharesSkewPlan,
    cap_factor: float = 3.0,
    n_shards: int = 4,
    max_workers: int = 4,
    speculate_after: float = 3.0,
    max_attempts: int = 3,
    injector=None,
    deadline_s: float | None = None,
    checksum_results: bool = True,
    device: str | torch.device = "cuda",
) -> JoinResult:
    """run_join with the reduce phase over-decomposed into reducer shards
    executed under speculative re-execution (straggler mitigation,
    DESIGN.md §5).  Each shard runs ``run_join`` on ``device`` restricted
    to a block of residual joins (the block join kernel reduces it on a
    card); results combine associatively (counts add, checksums add mod
    2^32), so duplicate completions are idempotent.

    Shard failures are retried up to ``max_attempts`` submissions; a shard
    that still fails raises here with its error — a partial join result is
    never returned silently.  ``injector`` (``repro_torch.testing.faults``)
    deterministically faults chosen attempts to exercise those paths.

    ``deadline_s`` arms the shard-level failure detector: an attempt silent
    past the deadline is declared failed and re-issued (DESIGN.md §5
    detection).  ``checksum_results`` (on by default) seals every shard
    result in a worker-side CRC32 envelope verified on receipt, so a
    corrupted result (``corrupt_result`` fault, or a real in-transit flip)
    becomes a retried attempt — never a wrong join answer."""
    from .straggler import run_with_speculation

    dev = _device(device)
    residuals = plan.residuals
    if not residuals:
        return run_join(query, data, plan, cap_factor, device=dev)
    n_shards = max(1, min(n_shards, len(residuals)))
    blocks = np.array_split(np.arange(len(residuals)), n_shards)

    def make_shard(idx_block):
        # a sub-plan containing only this block's residual joins, their
        # reducer ids rebased to start at 0
        offset = 0
        rebased = []
        for i in idx_block:
            r = residuals[i]
            rebased.append(ResidualPlan(r.combo, r.sizes, r.k_budget, r.solution, offset))
            offset += r.num_reducers
        sub_plan = SharesSkewPlan(plan.query, plan.q, plan.hh_values, tuple(rebased))

        def shard_fn():
            return run_join(query, data, sub_plan, cap_factor, device=dev)

        return shard_fn

    outcomes = run_with_speculation(
        [make_shard(b) for b in blocks],
        max_workers=max_workers,
        speculate_after=speculate_after,
        max_attempts=max_attempts,
        injector=injector,
        deadline_s=deadline_s,
        checksum_results=checksum_results,
    )
    if injector is not None:
        injector.resolve(outcomes)
    failed = [o for o in outcomes if o.error is not None]
    if failed:
        raise RuntimeError(
            f"{len(failed)} reduce shard(s) failed after "
            f"{max_attempts} attempts: "
            + "; ".join(f"shard {o.shard_id}: {o.error}" for o in failed)
        )
    results: list[JoinResult] = [o.result for o in outcomes]
    return JoinResult(
        count=sum(r.count for r in results),
        checksum=sum(r.checksum for r in results) & 0xFFFFFFFF,
        comm_tuples={
            rel.name: sum(r.comm_tuples[rel.name] for r in results)
            for rel in query.relations
        },
        reducer_loads=np.concatenate([r.reducer_loads for r in results]),
        overflow=sum(r.overflow for r in results),
    )
