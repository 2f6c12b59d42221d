"""Distributed shuffle over ``torch.distributed``: the counterpart of
``repro.mapreduce.shuffle``.

Each rank maps its shard of the input, packs per-destination-rank send
buffers of a static capacity (the paper's reducer bound q gives the
budget), exchanges them with one ``all_to_all_single`` per relation, bins
what it received into its own block of reducers and joins them.  Reducer
ids are block-partitioned over the ranks: rank r owns global reducers
``[r*g, (r+1)*g)``.  Counts, checksums, shuffle volume and overflow are
all-reduced and the per-reducer loads all-gathered, so every rank returns
the same ``JoinResult``.

The process group is chosen by ``repro_torch.distributed.resolve_group``:
the caller's, the default group, or this process's one-rank group (NCCL for
a CUDA device, gloo for the CPU); a mismatch raises.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.planner import SharesSkewPlan
from repro_torch.core.schema import JoinQuery
from repro_torch.distributed import rank_device, resolve_group

from .executor import JoinResult, _bin_cap, _device, predicted_comm
from .keys import map_phase
from .local_join import LocalJoinSpec, group_by_reducer, local_join_count_checksum

_M32 = 0xFFFFFFFF


def _pad_shard(arr: np.ndarray, d: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad leading dim to a multiple of d; returns (padded, valid_mask)."""
    n = arr.shape[0]
    n_pad = int(math.ceil(max(n, 1) / d) * d)
    out = np.zeros((n_pad,) + arr.shape[1:], dtype=arr.dtype)
    out[:n] = arr
    mask = np.zeros(n_pad, dtype=bool)
    mask[:n] = True
    return out, mask


def run_distributed(
    query: JoinQuery,
    data: dict[str, np.ndarray],
    plan: SharesSkewPlan,
    group: dist.ProcessGroup | None = None,
    cap_factor: float = 3.0,
    route_cap_factor: float = 3.0,
    device: str | torch.device = "cuda",
) -> JoinResult:
    """Execute the plan over the ranks of ``group``; every rank passes the
    whole ``data`` and takes its own block of each relation's rows, as the
    JAX package's ``P(axis_name)`` shards them.  ``route_cap_factor``
    scales each (rank, destination) send buffer above its expected share of
    the predicted shuffle; ``cap_factor`` each reducer's bin, as in
    ``run_join``.  For a binary join each rank's reduce is the block-join
    kernel on a card."""
    dev = _device(device)
    if not plan.residuals:  # some relation is empty -> join is empty
        return JoinResult(
            count=0,
            checksum=0,
            comm_tuples={r.name: 0 for r in query.relations},
            reducer_loads=np.zeros(0, dtype=np.int32),
            overflow=0,
        )
    group = resolve_group(group, dev)
    dev = rank_device(dev, group)
    d, me = group.size(), group.rank()
    k = plan.total_reducers
    g = int(math.ceil(k / d))  # reducers per rank
    cap = _bin_cap(plan, cap_factor)
    pred = predicted_comm(plan)
    route_caps = {
        name: max(32, int(math.ceil(pred[name] / (d * d) * route_cap_factor)) + 16)
        for name in pred
    }

    bins, valids, comm = {}, {}, []
    loads_local = torch.zeros(g, dtype=torch.int32, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    for rel in query.relations:
        padded, mask = _pad_shard(np.asarray(data[rel.name], dtype=np.int32), d)
        n_loc = padded.shape[0] // d
        rows = torch.from_numpy(padded[me * n_loc:(me + 1) * n_loc]).to(dev)
        rowmask = torch.from_numpy(mask[me * n_loc:(me + 1) * n_loc]).to(dev)
        dest = map_phase(plan, rel, rows)  # [n_loc, W]
        dest = torch.where(rowmask[:, None], dest, torch.full_like(dest, -1))
        n, w = dest.shape
        flat_dest = dest.reshape(-1)
        flat_rows = rows[:, None, :].expand(n, w, rows.shape[1]).reshape(-1, rows.shape[1])
        comm.append((flat_dest >= 0).sum())
        # ---- pack per-destination-rank send buffers ----
        dev_ids = torch.where(flat_dest >= 0, flat_dest // g, torch.full_like(flat_dest, -1))
        payload = torch.cat([flat_rows, flat_dest[:, None]], dim=1)
        send, send_ok, _, ov1 = group_by_reducer(dev_ids, payload, d, route_caps[rel.name])
        # ---- the shuffle: block j of the send buffers goes to rank j ----
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send.contiguous(), group=group)
        recv_ok = torch.empty(send_ok.shape, dtype=torch.int32, device=dev)
        dist.all_to_all_single(recv_ok, send_ok.to(torch.int32), group=group)
        rr = recv.reshape(-1, payload.shape[1])
        ok = recv_ok.reshape(-1) != 0
        local = torch.where(ok, rr[:, -1] - me * g, torch.full_like(rr[:, -1], -1))
        b, v, loads, ov2 = group_by_reducer(local, rr[:, :-1], g, cap)
        bins[rel.name], valids[rel.name] = b, v
        loads_local += loads
        overflow += ov1 + ov2
    count, checksum = local_join_count_checksum(LocalJoinSpec.from_query(query), bins, valids)
    # ---- reduce across ranks ----
    totals = torch.stack([count, checksum, overflow, *comm]).to(torch.int64)
    dist.all_reduce(totals, group=group)
    every = [torch.empty_like(loads_local) for _ in range(d)]
    dist.all_gather(every, loads_local, group=group)
    totals = totals.cpu().tolist()
    return JoinResult(
        count=int(totals[0]),
        checksum=int(totals[1]) & _M32,
        comm_tuples={rel.name: int(c) for rel, c in zip(query.relations, totals[3:])},
        reducer_loads=torch.cat(every).cpu().numpy()[:k],
        overflow=int(totals[2]),
    )
