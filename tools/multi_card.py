"""The distributed shuffle across several ranks: chip_smoke.py's phase 6b at a
world above one.  Every rank builds the same §9.1 data and plan, runs
``run_distributed`` three times over the default group (NCCL on the card,
one card a rank; gloo on the CPU), then the §9.2 3-way query; rank 0 holds
each result against ``run_join`` on its own card and against the host
oracle (count, checksum, every ``comm_tuples`` entry, every reducer's load,
no overflow) and prints the wall times.

  PYTHONPATH=src torchrun --nproc_per_node 4 tools/multi_card.py
  PYTHONPATH=src torchrun --nproc_per_node 4 tools/multi_card.py --device cpu \
      --n-r 40000 --n-s 4000 --q 200

Exits non-zero on a mismatch.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import plan_shares_skew, three_way_paper, two_way
from repro_torch.data import paper_2way, paper_3way
from repro_torch.distributed import world
from repro_torch.mapreduce import groupby_oracle_two_way, oracle_join, run_distributed, run_join


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-r", type=int, default=1_000_000)
    ap.add_argument("--n-s", type=int, default=100_000)
    ap.add_argument("--q", type=int, default=1000)
    args = ap.parse_args(argv)
    with world(args.device) as (group, dev):
        rank, n = group.rank(), group.size()
        cases = []
        query = two_way()
        data = paper_2way(np.random.default_rng(0), n_r=args.n_r, n_s=args.n_s)
        cases.append(("§9.1 2-way", query, data, plan_shares_skew(query, data, q=args.q), 3.0,
                      lambda: groupby_oracle_two_way(query, data)))
        q3 = three_way_paper()
        d3 = paper_3way(np.random.default_rng(0), n=2000, domain=20000)
        cases.append(("§9.2 3-way", q3, d3, plan_shares_skew(q3, d3, q=120), 5.0,
                      lambda: oracle_join(q3, d3)[:2]))
        for name, q_, d_, plan, cap, oracle in cases:
            secs = []
            for _ in range(3):  # the first warms the group and the caches
                dist.barrier(group)
                _sync(dev)
                t = time.perf_counter()
                res = run_distributed(q_, d_, plan, group=group, cap_factor=cap, device=dev)
                _sync(dev)
                secs.append(time.perf_counter() - t)
            if rank != 0:
                continue
            t = time.perf_counter()
            base = run_join(q_, d_, plan, cap_factor=cap, device=dev)
            _sync(dev)
            base_s = time.perf_counter() - t
            want = tuple(int(x) for x in oracle())
            print(f"[multi] {name}: world {n} ({group.name()}, {dev.type}), reducers "
                  f"{plan.total_reducers}: count={res.count} checksum={res.checksum} "
                  f"overflow={res.overflow} comm={res.comm_tuples}; run_distributed wall s "
                  f"{[round(x, 4) for x in secs]}, run_join {base_s:.4f} s; oracle {want}",
                  flush=True)
            same = (res.count, res.checksum, res.comm_tuples, res.overflow) == (
                base.count, base.checksum, base.comm_tuples, 0)
            same = same and np.array_equal(res.reducer_loads, base.reducer_loads)
            assert same and (res.count, res.checksum) == want, (res, base, want)
            print(f"[multi] {name}: equal to run_join in every field and to the oracle",
                  flush=True)


if __name__ == "__main__":
    main()
